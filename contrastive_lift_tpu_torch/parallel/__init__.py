"""Data-parallel training and rendering over ``torch.distributed``."""
