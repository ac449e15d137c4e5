"""Weakly supervised training of the NC head (counterpart of
``ncnet_tpu/train``): the weak loss, the Adam step with a frozen trunk,
the port's ``.npz`` checkpoints, the epoch loop and the CLI
``python -m ncnet_tpu_torch.train``."""
