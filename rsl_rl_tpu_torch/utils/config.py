"""YAML training-config loading (counterpart of ``rsl_rl_tpu/utils/config.py``).

Parses a YAML file into the nested dict the runners take, so a training
script is two lines::

    train_cfg = load_train_cfg("config/example_config.yaml")
    OnPolicyRunner(env, train_cfg, log_dir).learn(train_cfg["max_iterations"])

``yaml`` is imported when a file is loaded, not with this module: nothing
else of the port needs it.
"""

from __future__ import annotations


def load_train_cfg(path: str) -> dict:
    """Load a YAML config file and return the runner config dict.

    Accepts both layouts: a top-level ``runner:`` block (the repo's example
    config) or the runner keys at the root. A file that does not parse to a
    mapping raises ``ValueError``.
    """
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"Config file {path} did not parse to a mapping.")
    return cfg.get("runner", cfg)
