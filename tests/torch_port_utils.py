"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

The port is held against the JAX package on the CPU: inputs come from numpy
seeds, JAX variables are perturbed away from their (often zero) inits and
carried into the port by ``jax_to_state_dict``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from unibev_tpu_torch.utils.convert_jax import jax_to_state_dict


@pytest.fixture
def cuda_device():
    """The card, for tests of CUDA kernels (which have no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def perturb(variables, seed: int = 0, scale: float = 0.05):
    """JAX variables as numpy, moved off their inits so that no weight is
    zero (DCN offsets and MSDA sampling offsets start from zero in flax) and
    no BN is the identity (the frozen BN's ``constants`` and the running
    statistics in ``batch_stats``)."""
    rng = np.random.RandomState(seed)

    def walk(tree, col):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, col)
                continue
            a = np.asarray(v, np.float32)
            noise = rng.randn(*a.shape).astype(np.float32)
            if col in ("constants", "batch_stats") and k == "var":
                out[k] = a + 0.1 * np.abs(noise)
            elif col in ("constants", "batch_stats"):
                out[k] = a + 0.1 * noise
            else:
                out[k] = a + scale * noise
        return out

    return {col: walk(tree, col) for col, tree in variables.items()
            if col in ("params", "constants", "batch_stats")}


def port_state(variables, jax_path, torch_prefix):
    """Convert a JAX submodule's variables with the full-model converter.

    The submodule's tree is nested under ``jax_path`` (where it sits in the
    JAX UniBEV), converted, and the keys under ``torch_prefix`` returned with
    that prefix stripped, ready for the port submodule's ``load_state_dict``.
    """
    nested = {}
    for col, tree in variables.items():
        for name in reversed(jax_path):
            tree = {name: tree}
        nested[col] = tree
    sd = jax_to_state_dict(nested)
    assert all(k.startswith(torch_prefix) for k in sd), sorted(sd)[:5]
    return {k[len(torch_prefix):]: v for k, v in sd.items()}


def t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(a))
