from . import epoch, synth_torch

__all__ = ["epoch", "synth_torch"]
