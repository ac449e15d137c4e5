"""Weakly supervised training of the NC head, over a frozen trunk or with
its tail fine-tuned (counterpart of ``ncnet_tpu/train``): the weak loss,
the Adam step, the port's ``.npz`` checkpoints and the reader of the JAX
package's ``.msgpack`` ones, the epoch loop and the CLI
``python -m ncnet_tpu_torch.train``."""
