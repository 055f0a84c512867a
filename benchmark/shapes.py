"""The shape-defining values of a built model, which each configuration file
(``configs/<name>.json``, ``expect``) states and the run checks before it
measures: a later edit of the repository's config file cannot change the
yardstick unseen.  Which values a detector has is its detector file's
``of_model``."""

from __future__ import annotations

from typing import Dict

from torch import nn


def check(config: Dict, model: nn.Module, detector) -> None:
    """Fail where the built model differs from the configuration file's
    shape-defining values (``expect``)."""
    got = detector.of_model(model)
    bad = {k: (got.get(k), v) for k, v in config["expect"].items()
           if got.get(k) != v}
    if bad:
        raise ValueError(f"the model built from {config['config_file']} "
                         f"differs from {config['name']}'s values (built, "
                         f"expected): {bad}")
