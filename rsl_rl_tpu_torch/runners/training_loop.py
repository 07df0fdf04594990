"""The iteration loop the runners share (counterpart of the loops of
``rsl_rl_tpu/runners/on_policy_runner.py`` and ``multiseed_runner.py``):
split or whole-iteration dispatch, per-iteration logging, periodic
checkpoints, the git state and the profiler window.

- **Split** (the default): collect, then update, each timed on its own.
- **Fused** (``fuse_iteration``; implied by ``iterations_per_dispatch`` K >
  1): the whole iteration is one :class:`~rsl_rl_tpu_torch.utils.cuda_graph.IterationGraph`
  (a CUDA graph on the card), and K iterations are K replays with one
  metrics read. A group shorter than K (the run's remainder) replays the
  same graph fewer times. Each iteration is still logged, from the group's
  metrics, with the group's time split evenly and no learning time, as in
  the JAX package; checkpoints land at group boundaries, where the state is
  read back.

With a ``log_dir``: scalars go to the writer (``logger``: tensorboard, wandb
or neptune, ``utils/writers.py``), ``model_<it>.pt`` is saved every
``save_interval`` iterations (at the end of the group holding one) and at the
end of ``learn``, ``eval_interval`` runs the deterministic evaluation
(``utils/evaluation.py``, ``eval_num_steps`` steps, the env's longest episode
by default) every that many iterations (at the end of the group holding one,
after its save) and writes its ``Eval/*`` scalars, the git state of :attr:`git_status_repos` is stored after
the first iteration (or group), and ``profiler_trace_iterations = [first,
last]`` traces the groups holding those iterations with ``torch.profiler``
into ``<log_dir>/profile``. A run that resumes past ``first`` starts no
trace and stops none.

A runner provides ``_split_iteration()`` -> ``(metrics, collection_s,
learn_s)`` (host metrics), the fused iteration ``_graph_step(tree) ->
(tree, metrics)`` over the state tree ``_graph_state()`` /
``_set_graph_state(tree)``, ``_to_host(metrics)``, ``_log(it, start_iter,
tot_iter, metrics, collection_s, learn_s)``, ``save(path)`` and
``_run_eval(it)``.

On a mesh (``parallel/``; the runner's ``mesh``) rank 0 alone writes the
scalars and the git state (``disable_logs`` elsewhere). Whole-iteration
dispatch runs there too, as the JAX runner's jit over the sharded state
does: each rank captures its own graph, whose collectives (NCCL on the
card) are captured with it, and the ranks replay in lockstep, issuing the
same collectives in the same order; saves, evaluations and the git state
happen at group boundaries, outside the graph. On CUDA a group of another
backend (Gloo stages its collectives through the host) raises
``ValueError``: nothing falls back to eager. A host env asked to fuse trains
split on every device, as the JAX runner does (its iteration steps on the
host between device steps, so it is no device program).
"""

from __future__ import annotations

import os
import time
import warnings

import torch
import torch.distributed as dist

import rsl_rl_tpu_torch
from rsl_rl_tpu_torch.utils.cuda_graph import IterationGraph
from rsl_rl_tpu_torch.utils.git_state import store_code_state
from rsl_rl_tpu_torch.utils.writers import make_writer


def check_graph_backends(mesh, device: torch.device) -> None:
    """A fused iteration on ``mesh`` captures its collectives: on CUDA every
    process group of the mesh must be NCCL. Raises ``ValueError`` naming the
    backend of one that is not (Gloo stages its collectives through the
    host, which a CUDA graph cannot capture)."""
    if torch.device(device).type != "cuda":
        return
    for group in (mesh.data_group, mesh.model_group):
        backend = None if group is None else dist.get_backend(group)
        if backend not in (None, "nccl"):
            raise ValueError(
                f"fuse_iteration / iterations_per_dispatch > 1 on CUDA needs NCCL process groups, and this mesh's"
                f" group is {backend}: its collectives stage through the host, which a CUDA graph cannot capture."
                " Initialize the group with backend='nccl' (one rank a card), or train split.")


class TrainingLoop:
    """Mixin of the runners' loop; see the module docstring."""

    def _init_loop(self, log_dir: str | None, mesh=None) -> None:
        """Read the loop's runner keys from ``self.cfg``; ``mesh`` is the
        runner's rank layout (None: one process)."""
        self.log_dir = log_dir
        self.mesh = mesh
        self.disable_logs = mesh is not None and mesh.rank != 0
        self.save_interval = self.cfg.get("save_interval")
        if log_dir is not None and not self.save_interval:
            raise ValueError("a run with a log_dir needs the runner key save_interval (iterations between saves)")
        k = self.cfg.get("iterations_per_dispatch")
        self.iterations_per_dispatch = 1 if k is None else int(k)
        if self.iterations_per_dispatch < 1:
            raise ValueError(f"iterations_per_dispatch must be >= 1, got {self.iterations_per_dispatch}")
        self.fuse_iteration = bool(self.cfg.get("fuse_iteration")) or self.iterations_per_dispatch > 1
        self.eval_interval = int(self.cfg.get("eval_interval") or 0)
        if not getattr(self.env, "is_jax", True):
            # a host env steps on the host: no iteration is one device program,
            # so fuse_iteration resolves to the split iteration on every device
            if self.iterations_per_dispatch > 1:
                raise ValueError("iterations_per_dispatch > 1 requires a functional (device) env: host envs"
                                 " step on the host, so iterations cannot batch into one device program.")
            if self.eval_interval > 0:
                raise ValueError("eval_interval requires a functional (device) env: a host env has no second"
                                 " copy to roll (evaluate a host-env policy offline, through"
                                 " get_inference_policy()).")
            self.fuse_iteration = False
        if self.fuse_iteration and mesh is not None:
            check_graph_backends(mesh, self.device)
        if self.eval_interval > 0:
            if log_dir is None:
                # evaluation runs where its scalars have somewhere to go
                warnings.warn(
                    "eval_interval is set but log_dir is None: Eval/* scalars have nowhere to go and evaluation"
                    " will not run. Pass a log_dir to enable periodic evaluation.",
                    UserWarning,
                    stacklevel=3,
                )
            longest = int(torch.as_tensor(self.env.max_episode_length).max())
            self.eval_num_steps = int(self.cfg.get("eval_num_steps") or longest)
        self.logger_type = self.cfg.get("logger") or "tensorboard"
        self.writer = None
        self.git_status_repos = [rsl_rl_tpu_torch.__file__]
        #: the fused iteration, captured at the first fused ``learn``
        self.iteration_graph: IterationGraph | None = None
        self._profiler = None

    def _run(self, start_iter: int, tot_iter: int) -> None:
        window = self.cfg.get("profiler_trace_iterations")
        group = self.iterations_per_dispatch if self.fuse_iteration else 1
        if self.fuse_iteration:
            if self.iteration_graph is None:
                self.iteration_graph = IterationGraph(self._graph_step, self.device, self._graph_generators())
            # what was assigned to the state since the last learn
            self.iteration_graph.load(self._graph_state())
        it = start_iter
        while it < tot_iter:
            k = min(group, tot_iter - it)
            self._trace_start(window, it, k)
            rows = self._dispatch(k) if self.fuse_iteration else [self._split_iteration()]
            self._trace_stop(window, it, k)
            save_due = eval_due = False
            for j, (metrics, collection_s, learn_s) in enumerate(rows):
                self.current_learning_iteration = it + j
                self._log(it + j, start_iter, tot_iter, metrics, collection_s, learn_s)
                save_due |= self.log_dir is not None and (it + j) % self.save_interval == 0
                eval_due |= self.log_dir is not None and self.eval_interval > 0 and (it + j) % self.eval_interval == 0
            if save_due:
                self.save(os.path.join(self.log_dir, f"model_{self.current_learning_iteration}.pt"))
            if eval_due:
                # the state exists at group boundaries: the group's last iteration
                self._run_eval(self.current_learning_iteration)
            if it == start_iter:
                self._store_git_state()
            it += k
        if self.log_dir is not None:
            self.save(os.path.join(self.log_dir, f"model_{self.current_learning_iteration}.pt"))
        if self.writer is not None:
            self.writer.flush()

    def _graph_generators(self) -> list:
        """The generators the fused iteration draws from."""
        return [self.alg.generator]

    def _dispatch(self, k: int) -> list:
        """``k`` runs of the fused iteration and one read of their metrics."""
        graph = self.iteration_graph
        start = time.perf_counter()
        packs = [graph.run() for _ in range(k)]
        metrics = graph.unpack(packs)
        elapsed = time.perf_counter() - start
        self._set_graph_state(graph.state)
        return [(self._to_host(m), elapsed / k, 0.0) for m in metrics]

    # ------------------------------------------------------------ profiler

    def _trace_start(self, window, it: int, k: int) -> None:
        if window and self.log_dir is not None and it <= window[0] < it + k:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(os.path.join(self.log_dir, "profile")),
            )
            self._profiler.start()

    def _trace_stop(self, window, it: int, k: int) -> None:
        # only a trace this run started: a resume past window[0] started none
        if window and self._profiler is not None and it <= window[1] < it + k:
            self._profiler.stop()
            self._profiler = None

    # ------------------------------------------------------------- logging

    def _prepare_logging_writer(self) -> None:
        if self.log_dir is not None and self.writer is None and not self.disable_logs:
            self.writer = make_writer(self.logger_type, self.log_dir, self.cfg)
            if self.logger_type in ("wandb", "neptune"):
                self.writer.log_config(getattr(self.env, "cfg", {}), self.cfg, self.alg_cfg, self.policy_cfg)

    def _store_git_state(self) -> None:
        """The git status and diff of :attr:`git_status_repos` under
        ``<log_dir>/git``, uploaded by the W&B and Neptune writers."""
        if self.log_dir is None or self.disable_logs:
            return
        paths = store_code_state(self.log_dir, self.git_status_repos)
        if self.logger_type in ("wandb", "neptune"):
            for path in paths:
                self.writer.save_file(path)

    def _upload_model(self, path: str) -> None:
        if self.writer is not None and self.logger_type in ("wandb", "neptune"):
            self.writer.save_model(path, self.current_learning_iteration)

    def add_git_repo_to_log(self, repo_file_path: str) -> None:
        self.git_status_repos.append(repo_file_path)
