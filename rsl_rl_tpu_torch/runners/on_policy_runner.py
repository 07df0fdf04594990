"""On-policy training runner (counterpart of
``rsl_rl_tpu/runners/on_policy_runner.py``): config -> policy and algorithm by
registered name, then ``learn(n)`` runs the iterations (split into a
collection window and an update, or whole-iteration dispatch as a CUDA graph
with ``fuse_iteration`` / ``iterations_per_dispatch``;
``runners/training_loop.py``) and prints the console log. With a ``log_dir``
it writes the scalars (``logger``), ``model_<it>.pt`` every ``save_interval``
iterations, the git state and the ``profiler_trace_iterations`` trace.
``save`` / ``load`` / ``load_latest`` write and read checkpoints
(``utils/checkpoint.py``); ``get_inference_policy`` returns the
deterministic policy. ``eval_interval`` (with a ``log_dir``) evaluates the
deterministic policy on a fresh copy of the env every that many iterations
(``utils/evaluation.py``) and writes ``Eval/*``.

A host env (``env/host_env.py``: stateful, numpy, ``is_jax = False``, as
the JAX runner detects it) trains through the algorithm's host collection
loop (``make_host_collect_fn``): its iterations are split (``fuse_iteration``
resolves to False), ``iterations_per_dispatch > 1`` and ``eval_interval``
raise ``ValueError`` as in the JAX package, and ``init_at_random_ep_len``
scatters the env's ``episode_length_buf`` (from the runner's own generator)
or warns where it has none.

Data and tensor parallelism (``parallel/``), as the JAX runner's mesh: when
a ``torch.distributed`` process group is initialized (``distributed_init``)
each process is one rank of a ``("data",)`` layout, or of ``("data",
"model")`` with ``model_parallel_size: M`` (which must divide the rank
count; without a process group only 1 does). A device env is the global one
(``env.num_envs`` envs): each data rank resets and steps its contiguous
shard, the per-env keys those of the global index. A host env is this
rank's shard, reset with ``seed + data rank``; the global count is
``num_envs * data_size`` and the runner trains it through a
``HostShardingBridge``. The algorithm trains on the mesh
(``PPO.distribute``), so a run's losses and parameters are those of one
process over the global envs. Rank 0 alone logs, writes the git state and
writes checkpoints (every rank takes part in a save, whose tensor-parallel
slices are gathered); every rank runs an evaluation. A device env's per-env
``max_episode_length`` over the global envs is cut to the rank's shard
(``VecEnv.shard``, the runner's ``step_env``). ``fuse_iteration`` and
``iterations_per_dispatch`` run on a mesh of device envs as in one process
(NCCL groups on the card, ``runners/training_loop.py``); tensor parallelism
with a host env raises ``ValueError``.

The deprecated ``empirical_normalization`` key maps onto the
policy's ``actor_obs_normalization`` / ``critic_obs_normalization`` where
those are unset, with a ``DeprecationWarning``, as in the JAX package.
"""

from __future__ import annotations

import copy
import time
import warnings
from collections import deque

import numpy as np
import torch

import rsl_rl_tpu_torch.algorithms  # noqa: F401  (registers the algorithms)
import rsl_rl_tpu_torch.modules  # noqa: F401  (registers the policies)
from rsl_rl_tpu_torch.modules.policy import check_state_compatible
from rsl_rl_tpu_torch.modules.rnd import resolve_rnd_config
from rsl_rl_tpu_torch.modules.symmetry import resolve_symmetry_config
from rsl_rl_tpu_torch.parallel.host_dp import HostShardingBridge
from rsl_rl_tpu_torch.parallel.mesh import local_slice, make_tp_mesh
from rsl_rl_tpu_torch.parallel.tp import gather_tree_tp, reshard_module_tp, shard_tree_tp, unshard_module_tp
from rsl_rl_tpu_torch.runners.training_loop import TrainingLoop
from rsl_rl_tpu_torch.utils import trace
from rsl_rl_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from rsl_rl_tpu_torch.utils.device import resolve_device
from rsl_rl_tpu_torch.utils.evaluation import eval_seed, evaluate_policy
from rsl_rl_tpu_torch.utils.registry import resolve
from rsl_rl_tpu_torch.utils.resolvers import resolve_obs_groups

def map_empirical_normalization(cfg: dict, policy_cfg: dict) -> None:
    """The deprecated ``empirical_normalization`` runner key: fills the policy's
    ``actor_obs_normalization`` / ``critic_obs_normalization`` where they are
    unset, with a ``DeprecationWarning`` (the JAX package's
    ``OnPolicyRunner._construct_algorithm``)."""
    if cfg.get("empirical_normalization") is None:
        return
    warnings.warn(
        "The `empirical_normalization` parameter is deprecated. Please set `actor_obs_normalization`"
        " and `critic_obs_normalization` as part of the `policy` configuration instead.",
        DeprecationWarning,
        stacklevel=3,
    )
    for key in ("actor_obs_normalization", "critic_obs_normalization"):
        if policy_cfg.get(key) is None:
            policy_cfg[key] = cfg["empirical_normalization"]


class OnPolicyRunner(TrainingLoop):
    """Trains an actor-critic with an on-policy algorithm on one device, or
    as one rank of a data- (and tensor-) parallel layout."""

    training_type = "rl"

    def __init__(self, env, train_cfg: dict, log_dir: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        #: a host env steps on the host; the policy stays on ``device``
        self.is_jax_env = getattr(env, "is_jax", True)
        if self.is_jax_env and env.device != self.device:
            raise ValueError(f"the env lives on {env.device}, the runner on {self.device}")
        self.cfg = dict(train_cfg)
        self.alg_cfg = dict(train_cfg["algorithm"])
        self.policy_cfg = dict(train_cfg["policy"])
        self.env = env
        self.num_steps_per_env = self.cfg["num_steps_per_env"]
        model_parallel_size = int(self.cfg.get("model_parallel_size") or 1)
        if model_parallel_size > 1 and not self.is_jax_env:
            raise ValueError("model_parallel_size > 1 requires a functional (device) env: a host env trains"
                             " data-parallel only, so tensor parallelism would be silently inert.")
        # the rank layout (parallel/mesh.py) when a process group is
        # initialized or tensor parallelism is asked for, else None
        mesh = None
        if torch.distributed.is_initialized() or model_parallel_size > 1:
            mesh = make_tp_mesh(model_parallel_size)
        self._init_loop(log_dir, mesh)
        seed = self.seed = int(self.cfg.get("seed", 1))

        data_size = 1 if self.mesh is None else self.mesh.data_size
        if self.is_jax_env:
            #: the global env count; this rank steps its shard
            self.num_global_envs = env.num_envs
            offset, num_envs = (0, env.num_envs) if self.mesh is None else local_slice(self.mesh, env.num_envs)
            #: the env this rank resets and steps: on a mesh its shard, which
            #: holds its slice of a per-env ``max_episode_length``
            self.step_env = env if self.mesh is None else env.shard(offset, num_envs)
            env_state, obs = self.step_env.reset(seed, num_envs=num_envs, env_offset=offset)
        else:
            self.num_global_envs, num_envs = env.num_envs * data_size, env.num_envs
            self.step_env = env
            env_state = ()
            # each data rank's shard explores from its own seed
            rank_seed = seed + (0 if self.mesh is None else self.mesh.data_rank)
            obs = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                   for k, v in env.reset(seed=rank_seed).items()}
            # the draws of init_at_random_ep_len
            self._host_generator = torch.Generator().manual_seed(seed)
        default_sets = ["critic"] if self.training_type == "rl" else ["teacher"]
        if self.training_type == "rl" and self.alg_cfg.get("rnd_cfg") is not None:
            default_sets.append("rnd_state")
        self.cfg["obs_groups"] = resolve_obs_groups(obs, self.cfg["obs_groups"], default_sets)
        self.alg = self._construct_algorithm(obs, seed)
        if self.mesh is not None:
            self.alg.distribute(self.mesh)
        self.collect_state = self.alg.init_collect_state(env_state, obs, num_envs)
        #: the host env's bridge to the mesh (data parallelism), else None
        self._host_bridge = None
        if not self.is_jax_env and self.mesh is not None:
            self._host_bridge = HostShardingBridge(self.mesh, self.device)
        #: the host env's collection window (``make_host_collect_fn``)
        self.host_collect = None if self.is_jax_env else self.alg.make_host_collect_fn(
            env, self.num_steps_per_env, bridge=self._host_bridge)

        self.tot_timesteps = 0
        self.tot_time = 0.0
        self.current_learning_iteration = 0
        #: one dict per finished iteration: collection_s, learn_s, steps_per_s, metrics
        self.history: list[dict] = []
        # (rew_sum, len_sum, extrinsic sum, intrinsic sum, count) per iteration
        self._ep_window = deque()

    def _construct_algorithm(self, obs, seed: int):
        """Policy and algorithm from the config by registered name."""
        map_empirical_normalization(self.cfg, self.policy_cfg)
        self.alg_cfg = resolve_rnd_config(self.alg_cfg, obs, self.cfg["obs_groups"], self.env)
        self.alg_cfg = resolve_symmetry_config(self.alg_cfg, self.env)
        policy_class = resolve("policy", self.policy_cfg.pop("class_name"))
        policy = policy_class(obs, self.cfg["obs_groups"], self.env.num_actions,
                              device=self.device, seed=seed, **self.policy_cfg)
        alg_class = resolve("algorithm", self.alg_cfg.pop("class_name"))
        return alg_class(policy, seed=seed + 1, **self.alg_cfg)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def learn(self, num_learning_iterations: int, init_at_random_ep_len: bool = False) -> None:
        self._prepare_logging_writer()
        if init_at_random_ep_len:
            if self.is_jax_env:
                self.collect_state.env_state = self.step_env.randomize_episode_length(self.collect_state.env_state)
            else:
                self._randomize_host_episode_length()
        start_iter = self.current_learning_iteration
        self._run(start_iter, start_iter + num_learning_iterations)

    def _randomize_host_episode_length(self) -> None:
        """Scatter a host env's ``episode_length_buf`` over ``[0,
        max_episode_length)``: in place when it is a writable ndarray (a view
        into the simulator's state sees the write), else by replacing the
        attribute; without the buffer, warn."""
        buf = getattr(self.env, "episode_length_buf", None)
        if buf is None:
            warnings.warn("init_at_random_ep_len requires the host env to expose an episode_length_buf;"
                          " ignoring.", stacklevel=3)
            return
        high = int(np.max(self.env.max_episode_length))
        # drawn for the global envs, this data rank's rows kept
        n = int(np.size(buf))
        rank, size = (0, 1) if self.mesh is None else (self.mesh.data_rank, self.mesh.data_size)
        values = torch.randint(0, high, (n * size,), generator=self._host_generator)[rank * n:(rank + 1) * n]
        values = values.numpy().reshape(np.shape(buf))
        if isinstance(buf, np.ndarray) and buf.flags.writeable:
            buf[:] = values.astype(buf.dtype)
        else:
            self.env.episode_length_buf = values.astype(np.asarray(buf).dtype)

    def _split_iteration(self):
        # the device stamps (utils/trace.py) bracket collect and update; the
        # update's span also holds the read of the metrics and the stamps
        start = time.perf_counter()
        with trace.span("alg.collect"):
            trace.begin_iteration(self.device)
            if self.is_jax_env:
                cs, rollout, cm = self.alg.collect(self.step_env, self.collect_state, self.num_steps_per_env)
            else:
                cs, rollout, cm = self.host_collect(self.collect_state)
            trace.end_collection()
        self._sync()
        collection_time = time.perf_counter() - start

        with trace.span("alg.update"):
            start = time.perf_counter()
            cs, um = self.alg.update(cs, rollout)
            trace.end_iteration()
            self._sync()
            learn_time = time.perf_counter() - start
            metrics = {k: float(v) for k, v in {**cm, **um}.items()}
            stamps = trace.take_stamps()
            trace.book(trace.current(), stamps.labels, stamps.read(), stamps.clock, stamps.counts)

        self.collect_state = cs
        return metrics, collection_time, learn_time

    # the fused iteration (training_loop.TrainingLoop): the collect state is
    # its state tree; the policy and optimizer update in place

    def _graph_state(self):
        return self.collect_state

    def _set_graph_state(self, cs) -> None:
        self.collect_state = cs

    def _graph_step(self, cs):
        trace.begin_iteration(self.device)
        cs, rollout, cm = self.alg.collect(self.step_env, cs, self.num_steps_per_env)
        trace.end_collection()
        cs, um = self.alg.update(cs, rollout)
        trace.end_iteration()
        return cs, {**cm, **um}

    def _to_host(self, metrics: dict) -> dict:
        return {k: float(v) for k, v in metrics.items()}

    def _run_eval(self, it: int) -> None:
        """One deterministic evaluation (a fresh env copy from a seed apart
        from training's, ``act_inference`` actions); writes ``Eval/*``. It
        draws nothing from the training's generators."""
        m = evaluate_policy(self.env, self.alg.policy, None, self.eval_num_steps, eval_seed(self.seed, it))
        if self.disable_logs:
            return
        count = m["Eval/episode_count"]
        self.writer.add_scalar("Eval/episode_count", count, it)
        if count > 0:
            for key in ("Eval/mean_reward", "Eval/mean_episode_length", "Eval/min_return", "Eval/max_return"):
                self.writer.add_scalar(key, m[key], it)
            print(f"Evaluation at iteration {it}: mean return {m['Eval/mean_reward']:.2f} over {int(count)}"
                  " episodes (deterministic policy)")
        else:
            print(f"Evaluation at iteration {it}: no episode completed within the eval budget (raise"
                  " eval_num_steps)")

    def _episode_window_stats(self, metrics: dict) -> tuple[float, float, float, float, float]:
        """Means over a trailing window of about 100 finished episodes: reward,
        length, extrinsic and intrinsic reward, and the episode count."""
        self._ep_window.append(tuple(metrics[k] for k in ("ep_reward_sum", "ep_length_sum", "ep_ereward_sum",
                                                          "ep_ireward_sum", "ep_count")))
        while len(self._ep_window) > 1 and sum(e[4] for e in self._ep_window) - self._ep_window[0][4] >= 100:
            self._ep_window.popleft()
        count = sum(e[4] for e in self._ep_window)
        if count == 0:
            return 0.0, 0.0, 0.0, 0.0, 0.0
        return (*(sum(e[i] for e in self._ep_window) / count for i in range(4)), count)

    def _log(self, it, start_iter, tot_iter, metrics, collection_time, learn_time, width=80, pad=35):
        collection_size = self.num_steps_per_env * self.num_global_envs
        self.tot_timesteps += collection_size
        iteration_time = collection_time + learn_time
        self.tot_time += iteration_time
        fps = collection_size / iteration_time
        self.history.append({
            "iteration": it,
            "collection_s": collection_time,
            "learn_s": learn_time,
            "steps_per_s": fps,
            "metrics": metrics,
        })
        mean_reward, mean_ep_len, mean_erew, mean_irew, ep_count = self._episode_window_stats(metrics)
        if self.disable_logs:
            return
        if self.writer is not None:
            self._write_scalars(it, metrics, int(fps), collection_time, learn_time, mean_reward, mean_ep_len,
                                mean_erew, mean_irew, ep_count)
        header = f" \033[1m Learning iteration {it}/{tot_iter} \033[0m "
        log = (
            f"{'#' * width}\n{header.center(width, ' ')}\n\n"
            f"{'Computation:':>{pad}} {fps:.0f} steps/s (collection: {collection_time:.3f}s,"
            f" learning {learn_time:.3f}s)\n"
            f"{'Mean action noise std:':>{pad}} {metrics['Policy/mean_noise_std']:.2f}\n"
        )
        for key, value in metrics.items():
            name = key.removeprefix("Loss/")
            if key.startswith("Loss/") and name not in ("kl", "learning_rate"):
                log += f"{f'Mean {name} loss:':>{pad}} {value:.4f}\n"
        if ep_count > 0 and "Rnd/weight" in metrics:
            log += f"{'Mean extrinsic reward:':>{pad}} {mean_erew:.2f}\n"
            log += f"{'Mean intrinsic reward:':>{pad}} {mean_irew:.2f}\n"
        if ep_count > 0:
            log += f"{'Mean reward:':>{pad}} {mean_reward:.2f}\n"
            log += f"{'Mean episode length:':>{pad}} {mean_ep_len:.2f}\n"
        eta = self.tot_time / (it - start_iter + 1) * (tot_iter - it - 1)
        log += (
            f"{'-' * width}\n"
            f"{'Total timesteps:':>{pad}} {self.tot_timesteps}\n"
            f"{'Iteration time:':>{pad}} {iteration_time:.2f}s\n"
            f"{'Time elapsed:':>{pad}} {time.strftime('%H:%M:%S', time.gmtime(self.tot_time))}\n"
            f"{'ETA:':>{pad}} {time.strftime('%H:%M:%S', time.gmtime(eta))}\n"
        )
        print(log)

    def _write_scalars(self, it, metrics, fps, collection_time, learn_time, mean_reward, mean_ep_len,
                       mean_erew, mean_irew, ep_count) -> None:
        """The writer's scalars of an iteration (the JAX package's ``_log``)."""
        w = self.writer
        for key, value in metrics.items():
            if key.startswith("Loss/"):
                w.add_scalar(key, value, it)
        w.add_scalar("Policy/mean_noise_std", metrics["Policy/mean_noise_std"], it)
        w.add_scalar("Perf/total_fps", fps, it)
        w.add_scalar("Perf/collection time", collection_time, it)
        w.add_scalar("Perf/learning_time", learn_time, it)
        for key, value in metrics.items():
            if key.startswith("extras/"):
                name = key.removeprefix("extras/")
                w.add_scalar(name if "/" in name else f"Episode/{name}", value, it)
        if "Rnd/weight" in metrics:
            w.add_scalar("Rnd/weight", metrics["Rnd/weight"], it)
        if ep_count > 0:
            if "Rnd/weight" in metrics:
                w.add_scalar("Rnd/mean_extrinsic_reward", mean_erew, it)
                w.add_scalar("Rnd/mean_intrinsic_reward", mean_irew, it)
            w.add_scalar("Train/mean_reward", mean_reward, it)
            w.add_scalar("Train/mean_episode_length", mean_ep_len, it)
            if self.logger_type != "wandb":
                w.add_scalar("Train/mean_reward/time", mean_reward, self.tot_time)
                w.add_scalar("Train/mean_episode_length/time", mean_ep_len, self.tot_time)

    # ----------------------------------------------------------- checkpoints

    def save(self, path: str, infos=None) -> None:
        """Write the training state to ``path``: the policy's state dict
        (parameters and normalizer moments), the optimizer's moments and
        count, the learning rate, the iteration and ``infos`` (plain data);
        with RND also its state dict (predictor, target, normalizers,
        counter) and its optimizer's state. On a mesh every rank calls it: the
        tensor-parallel slices are gathered (``gather_tree_tp``) and rank 0
        writes the full state, which loads into any layout."""
        alg = self.alg
        model, opt = alg.policy.state_dict(), alg.optimizer_state()
        if alg.tp_specs is not None:
            model = gather_tree_tp(model, self.mesh, alg.tp_specs)
            opt = {**opt, **{k: gather_tree_tp(opt[k], self.mesh, alg.tp_specs) for k in ("mu", "nu")}}
        if self.disable_logs:
            return
        state = {
            "model": model,
            "opt_state": opt,
            "lr": alg.lr,
            "iter": int(self.current_learning_iteration),
            "infos": infos,
        }
        if alg.rnd is not None:
            state["rnd"] = alg.rnd.state_dict()
            state["rnd_opt_state"] = alg.rnd_optimizer.optimizer_state()
        save_checkpoint(path, state)
        self._upload_model(path)

    def load(self, path: str, load_optimizer: bool = True):
        """Restore a checkpoint; returns its ``infos``.

        The policy decides from the model state whether this is a resume
        (its ``load_policy_state`` flag): on a resume the RND state (which a
        run with RND requires), the optimizer states, the learning rate (with
        ``load_optimizer``) and the iteration are restored; on a teacher bootstrap (an RL checkpoint loaded into a
        distillation policy) the checkpoint's optimizer extras belong to the
        teacher's training and are dropped. A checkpoint that neither
        matches the policy nor remaps raises ``ValueError`` with both causes.
        Tensors land on the runner's device. Under tensor parallelism every
        rank loads the full state: the sliced parameters are gathered for the
        load and sliced again after it, and the optimizer moments are sliced.
        """
        loaded = load_checkpoint(path, map_location=self.device)
        specs = self.alg.tp_specs
        if specs is None:
            resumed = self._load_policy(path, loaded)
        else:
            unshard_module_tp(self.alg.policy, self.mesh, specs)
            try:
                resumed = self._load_policy(path, loaded)
            finally:
                reshard_module_tp(self.alg.policy, self.mesh, specs)
            if "opt_state" in loaded:
                opt = loaded["opt_state"]
                loaded["opt_state"] = {**opt, **{k: shard_tree_tp(opt[k], self.mesh, specs) for k in ("mu", "nu")}}
        if resumed:
            rnd = self.alg.rnd
            if rnd is not None:
                # strict: a run with RND resumes only with RND state
                if "rnd" not in loaded:
                    raise ValueError(f"Checkpoint {path} has no RND state but this run has RND enabled;"
                                     " it was saved by a non-RND configuration.")
                check_state_compatible(rnd.state_dict(), loaded["rnd"], "RND state")
                rnd.load_state_dict(loaded["rnd"])
            if load_optimizer:
                self.alg.load_optimizer_state(loaded["opt_state"], loaded["lr"])
                if rnd is not None and "rnd_opt_state" in loaded:
                    opt = self.alg.rnd_optimizer
                    opt.load_optimizer_state(loaded["rnd_opt_state"], opt.lr)
            self.current_learning_iteration = int(loaded["iter"])
        return loaded["infos"]

    def _load_policy(self, path: str, loaded: dict) -> bool:
        """Load the checkpoint's model state into the policy; returns whether
        it is a resume (the policy's ``load_policy_state``)."""
        policy = self.alg.policy
        structural_err = None
        try:
            check_state_compatible(policy.state_dict(), loaded["model"])
        except ValueError as err:
            structural_err = err
        try:
            return policy.load_policy_state(loaded["model"])
        except (ValueError, RuntimeError, KeyError) as remap_err:
            if structural_err is not None:
                raise ValueError(
                    f"Checkpoint {path!r} neither restores into the configured policy"
                    f" ({structural_err}) nor remaps as a teacher bootstrap ({remap_err}); it is"
                    " incompatible with this configuration or corrupted."
                ) from remap_err
            raise

    def load_latest(self, log_dir: str | None = None) -> bool:
        """Resume from the newest ``model_<it>.pt`` in ``log_dir`` (this
        runner's by default); returns False when there is none."""
        path = latest_checkpoint(log_dir or self.log_dir or "")
        if path is None:
            return False
        self.load(path)
        return True

    # ------------------------------------------------------------- inference

    def get_inference_policy(self, device=None):
        """A deterministic policy ``obs -> action`` (the mean, no gradients).
        A recurrent policy's callable keeps its hidden state between calls;
        ``.reset(dones)`` zeroes it where ``dones`` is set (all of it with no
        argument). ``device`` runs a copy of the policy there."""
        policy = self.alg.policy
        if device is not None:
            device = resolve_device(device)
            policy = copy.deepcopy(policy).to(device)
            policy.device = device
        holder = {"carry": policy.initial_carry(self.env.num_envs)}

        @torch.no_grad()
        def policy_fn(obs):
            action, holder["carry"] = policy.act_inference(obs, holder["carry"])
            return action

        def reset(dones=None):
            if dones is None:
                holder["carry"] = policy.initial_carry(self.env.num_envs)
            else:
                holder["carry"] = policy.reset_carry(holder["carry"], dones)

        policy_fn.reset = reset
        return policy_fn
