"""The program's side of each server rule a mix names, one module a rule
(`<rule>.py`): how the program builds it and where its state keeps what
the reference's rule is compared on."""
