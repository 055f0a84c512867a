"""What the port's train and test CLIs share: the config with its
``--cfg-options``, the device, and the refusal of a multi-process launch."""

from __future__ import annotations

from typing import Sequence

import torch

from unibev_tpu_torch.config.config import Config, parse_cfg_option_value


def load_config(path: str, cfg_options: Sequence[str] = ()) -> Config:
    """``Config.fromfile(path)`` with ``key=value`` dotted overrides."""
    cfg = Config.fromfile(path)
    opts = {}
    for kv in cfg_options:
        k, v = kv.split("=", 1)
        opts[k] = parse_cfg_option_value(v)
    if opts:
        cfg.merge_from_dict(opts)
    return cfg


def cli_device(name: str) -> torch.device:
    """``--device``: the card unless the caller asks for the CPU; a CUDA
    device that is not there raises (no silent run on the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available "
                           f"(pass --device cpu to run on the CPU)")
    return device


def single_process(launcher: str, gpus: int = 1) -> None:
    """The port runs one process on one card: a launcher or several GPUs
    raise, naming the roadmap item that brings them."""
    if launcher != "none" or gpus > 1:
        raise NotImplementedError(
            f"--launcher {launcher} / {gpus} GPUs: the port runs one process "
            f"on one card; data-parallel training is ROADMAP A7 (not ported)")
