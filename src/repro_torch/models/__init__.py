from repro_torch.models.model import LM

__all__ = ["LM"]
