"""Checkpoint conversion (counterpart of virnet_tpu/convert/).

The port's parameter names are the reference torch keys, so importing a
released ``.pth`` is loading it (``load_pth``, with BatchNorm folded into
its conv where the state dict holds conv+BN pairs, ``merge_bn``).
``to_jax_params`` carries a state dict across to the JAX package's flax
tree of numpy arrays and ``from_jax_params`` back; ``save_torch_checkpoint``
writes the reference-loadable ``.pth``.
"""

from .merge_bn import fold_bn, find_conv_bn_pairs, merge_bn_state_dict
from .torch_export import from_jax_params, save_torch_checkpoint
from .torch_import import load_pth, to_jax_params

__all__ = ["fold_bn", "find_conv_bn_pairs", "from_jax_params", "load_pth",
           "merge_bn_state_dict", "save_torch_checkpoint", "to_jax_params"]
