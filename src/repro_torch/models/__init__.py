"""The port's models (`repro.models`' counterpart): the config-driven
transformer for the attention-only decoders."""
from repro_torch.models.model import Model, build_model
