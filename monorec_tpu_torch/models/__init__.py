from monorec_tpu_torch.models.monorec import MonoRec, MonoRecConfig

__all__ = ["MonoRec", "MonoRecConfig"]
