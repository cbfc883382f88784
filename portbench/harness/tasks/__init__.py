"""The program's side of each task a mix names, one module a task
(`<task>.py`): the program's task built over the benchmark's weights."""
