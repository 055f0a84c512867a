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


def fake_nuscenes_tree(root: str):
    """The on-disk fake nuScenes tree of tests/test_real_data_e2e.py (4
    samples, 2 cameras at 64x96, 512 LiDAR points each), its info files from
    tools/create_data.py (3 train samples, 1 val) and its config on
    configs/smoke/tiny_lc.py; returns the config's path."""
    import os.path as osp
    import subprocess
    import sys

    from test_real_data_e2e import CONFIG_TMPL, REPO, build_tree

    build_tree(root)
    r = subprocess.run(
        [sys.executable, osp.join(REPO, "tools/create_data.py"), "nuscenes",
         "--root-path", root, "--version", "v1.0-mini"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    cfg_path = osp.join(root, "cfg_files.py")
    with open(cfg_path, "w") as f:
        f.write(CONFIG_TMPL.format(repo=REPO, root=root))
    return cfg_path


def assert_same(got, want, path="item"):
    """``got`` equals ``want`` exactly, recursively: dicts with the same
    keys, sequences of the same length, arrays of the same dtype and values
    (NaN equal to NaN); numpy generators by their state."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (path, type(got))
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, np.random.Generator):
        assert got.bit_generator.state == want.bit_generator.state, path
    else:
        assert type(got) is type(want) and (got == want or got != got), (
            path, got, want)
