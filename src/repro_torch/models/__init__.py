"""The port's models (`repro.models`' counterpart): the config-driven
transformer — attention (GQA, local/global, MLA), Mamba-2 SSD, the MoE
FFN, the Zamba2-style shared block and the encoder-decoder."""
from repro_torch.models.model import Model, build_model
