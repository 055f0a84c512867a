"""What the port's train and test CLIs share: the config with its
``--cfg-options``, the device, and the launcher."""

from __future__ import annotations

import os
from typing import Sequence

import torch

from unibev_tpu_torch.config.config import Config, parse_cfg_option_value
from unibev_tpu_torch.parallel.dist import get_rank, init_dist


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


# what the port would need to map each of the JAX CLI's other launchers
UNMAPPED_LAUNCHERS = {
    "slurm": "it reads no SLURM environment (SLURM_PROCID, SLURM_NTASKS, "
             "the node list) into a rendezvous",
    "mpi": "it reads no MPI environment (OMPI_COMM_WORLD_RANK / SIZE, "
           "PMI_RANK) into a rendezvous",
    "tpu": "it runs on CUDA cards or the CPU, with no TPU runtime",
}


def launch(launcher: str, device: torch.device, gpus: int = 1) -> torch.device:
    """``--launcher``: ``none`` runs one process on ``device``;
    ``pytorch`` joins the process group that ``python -m
    torch.distributed.run`` describes (one process per card, NCCL; gloo with
    ``--device cpu``) and returns the rank's device.  The other launchers
    of the JAX CLI raise, naming what the port lacks for them, and so does
    more than one GPU in one process."""
    if launcher in UNMAPPED_LAUNCHERS:
        raise NotImplementedError(
            f"--launcher {launcher}: the port does not map it: "
            f"{UNMAPPED_LAUNCHERS[launcher]}; run one process per card under "
            f"python -m torch.distributed.run with --launcher pytorch")
    if gpus > 1:
        raise NotImplementedError(
            f"{gpus} GPUs: a process drives one card; run one process per "
            f"card under python -m torch.distributed.run with --launcher "
            f"pytorch")
    if launcher == "none":
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError("started by a launcher with WORLD_SIZE > 1: "
                               "pass --launcher pytorch")
        return device
    return init_dist(device.type)


def log_level(level: str = "INFO") -> str:
    """``level`` on rank 0; WARNING on the others, so that one rank speaks
    for the group."""
    return level if get_rank() == 0 else "WARNING"
