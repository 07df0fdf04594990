"""Logging writer backends: TensorBoard, Weights & Biases, Neptune
(counterpart of ``rsl_rl_tpu/utils/writers.py``).

TensorBoard (``tensorboardX``) is the base writer; the W&B and Neptune
writers wrap it and dual-write every scalar, upload the run config, saved
models and git-diff files. Every backend is imported inside its writer's
constructor, so the package imports without them; a run with a ``log_dir``
on a machine without ``tensorboardX`` raises ``ImportError`` naming it.
"""

from __future__ import annotations

import os
from typing import Any


class TensorBoardWriter:
    """Thin wrapper over ``tensorboardX.SummaryWriter``."""

    def __init__(self, log_dir: str, flush_secs: int = 10, cfg: dict | None = None):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise ImportError("tensorboardX is required to write the logs of a run with a log_dir.") from e

        self.writer = SummaryWriter(log_dir=log_dir, flush_secs=flush_secs)

    def add_scalar(self, tag: str, value: Any, step: int) -> None:
        self.writer.add_scalar(tag, float(value), step)

    def log_config(self, env_cfg, runner_cfg, alg_cfg, policy_cfg) -> None:
        pass

    def save_model(self, path: str, iteration: int) -> None:
        pass

    def save_file(self, path: str) -> None:
        pass

    def flush(self) -> None:
        """Force buffered events to disk (the SummaryWriter otherwise flushes
        on its ``flush_secs`` timer); called when ``learn`` returns, so short
        runs leave complete event files."""
        self.writer.flush()

    def stop(self) -> None:
        self.writer.close()


class WandbSummaryWriter(TensorBoardWriter):
    """TensorBoard writer that dual-writes to Weights & Biases."""

    def __init__(self, log_dir: str, flush_secs: int = 10, cfg: dict | None = None):
        super().__init__(log_dir, flush_secs)
        try:
            import wandb
        except ImportError as e:
            raise ImportError("Wandb is required to log to Weights and Biases.") from e
        cfg = cfg or {}
        try:
            project = cfg["wandb_project"]
        except KeyError:
            raise KeyError("Please specify wandb_project in the runner config.")
        entity = os.environ.get("WANDB_USERNAME")
        wandb.init(project=project, entity=entity)
        # the generated name in project-number form
        wandb.run.name = cfg.get("experiment_name", "run") + "_" + wandb.run.name.split("-")[-1]
        self._wandb = wandb
        self.name_map = {
            "Train/mean_reward/time": "Train/mean_reward_time",
            "Train/mean_episode_length/time": "Train/mean_episode_length_time",
        }
        run_name = os.path.split(log_dir)[-1]
        self._wandb.log({"log_dir": run_name})

    def _map_path(self, path: str) -> str:
        return self.name_map.get(path, path)

    def add_scalar(self, tag: str, value: Any, step: int) -> None:
        super().add_scalar(tag, value, step)
        self._wandb.log({self._map_path(tag): float(value)}, step=step)

    def log_config(self, env_cfg, runner_cfg, alg_cfg, policy_cfg) -> None:
        self._wandb.config.update(
            {"runner_cfg": runner_cfg, "policy_cfg": policy_cfg, "alg_cfg": alg_cfg,
             "env_cfg": env_cfg if isinstance(env_cfg, dict) else str(env_cfg)}
        )

    def save_model(self, path: str, iteration: int) -> None:
        self._wandb.save(path, base_path=os.path.dirname(path))

    def save_file(self, path: str) -> None:
        self._wandb.save(path, base_path=os.path.dirname(path))

    def stop(self) -> None:
        self._wandb.finish()
        super().stop()


class NeptuneSummaryWriter(TensorBoardWriter):
    """TensorBoard writer that dual-writes to Neptune."""

    def __init__(self, log_dir: str, flush_secs: int = 10, cfg: dict | None = None):
        super().__init__(log_dir, flush_secs)
        try:
            import neptune
        except ImportError as e:
            raise ImportError("Neptune is required to log to Neptune.ai.") from e
        cfg = cfg or {}
        try:
            project = cfg["neptune_project"]
        except KeyError:
            raise KeyError("Please specify neptune_project in the runner config.")
        token = os.environ.get("NEPTUNE_API_TOKEN")
        self.run = neptune.init_run(
            project=project, api_token=token, name=cfg.get("run_name"),
        )
        run_name = os.path.split(log_dir)[-1]
        self.run["log_dir"].log(run_name)

    def add_scalar(self, tag: str, value: Any, step: int) -> None:
        super().add_scalar(tag, value, step)
        self.run[tag].log(float(value), step=step)

    def log_config(self, env_cfg, runner_cfg, alg_cfg, policy_cfg) -> None:
        self.run["runner_cfg"] = str(runner_cfg)
        self.run["policy_cfg"] = str(policy_cfg)
        self.run["alg_cfg"] = str(alg_cfg)
        self.run["env_cfg"] = str(env_cfg)

    def save_model(self, path: str, iteration: int) -> None:
        self.run[f"model/saved_model_{iteration}"].upload(path)

    def save_file(self, path: str) -> None:
        name = path.rsplit("/", 1)[-1].split(".")[0]
        self.run[f"git_diff/{name}"].upload(path)

    def stop(self) -> None:
        self.run.stop()
        super().stop()


def make_writer(logger_type: str, log_dir: str, cfg: dict | None = None):
    """The writer of ``logger_type`` (tensorboard, wandb or neptune)."""
    logger_type = (logger_type or "tensorboard").lower()
    if logger_type == "tensorboard":
        return TensorBoardWriter(log_dir, cfg=cfg)
    if logger_type == "wandb":
        return WandbSummaryWriter(log_dir, cfg=cfg)
    if logger_type == "neptune":
        return NeptuneSummaryWriter(log_dir, cfg=cfg)
    raise ValueError("Logger type not found. Please choose 'neptune', 'wandb' or 'tensorboard'.")
