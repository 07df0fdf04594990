"""Whole-iteration dispatch (``fuse_iteration``, ``iterations_per_dispatch``)
in the port's runners, and the ``log_dir`` surface it goes with: the writer,
periodic checkpoints, the git state and the profiler window.

On the CPU the fused iteration runs eagerly (``utils/cuda_graph.py``), so a
fused or K-dispatched run must equal the split run bit for bit: the same
operations in the same order. The algorithms keep every tensor a CUDA graph
would replay in its storage. The log and save contract is held against the
JAX runner on the same ``NLinkPendulum`` config: the same iterations logged
under the same tags, the same group-boundary checkpoints and step counts.
The test marked ``cuda`` holds graph replays against eager on the card; like
``tests/test_torch_port_kernels.py`` the file imports JAX only inside the
test that compares with it, so it also runs on a machine with a card and no
JAX (``--noconftest``).

Tolerances: port against port, bit for bit (``torch.equal``); port against
JAX, the logged iterations, tags, checkpoint iterations and counts exactly.
"""

import copy
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from rsl_rl_tpu_torch.env import DomainRandomizedNLink, NLinkPendulum
from rsl_rl_tpu_torch.runners import DistillationRunner, MultiSeedRunner, OnPolicyRunner
from rsl_rl_tpu_torch.utils import cuda_graph
from rsl_rl_tpu_torch.utils.cuda_graph import IterationGraph, flatten

N, LINKS, T, G = 8, 3, 4, 2
GROUPS = {"policy": ["policy"], "critic": ["policy"]}


#: RND with both normalizers and a schedule that moves over the first iterations
RND_CFG = {"weight": 0.5, "num_outputs": 4, "predictor_hidden_dims": [-1], "target_hidden_dims": [-1],
           "state_normalization": True, "reward_normalization": True, "learning_rate": 1e-3,
           "weight_schedule": {"mode": "linear", "initial_step": 2, "final_step": 30, "final_value": 1.0}}


def _cfg(recurrent=True, rnd=False, **keys):
    policy = {"class_name": "ActorCriticRecurrent" if recurrent else "ActorCritic",
              "actor_hidden_dims": [16], "critic_hidden_dims": [16],
              "actor_obs_normalization": True, "critic_obs_normalization": True}
    if recurrent:
        policy.update(rnn_type="gru", rnn_hidden_dim=8)
    algorithm = {"class_name": "PPO", "num_learning_epochs": 2, "num_mini_batches": 2}
    obs_groups = GROUPS
    if rnd:
        algorithm["rnd_cfg"] = dict(RND_CFG)
        obs_groups = {**GROUPS, "rnd_state": ["policy"]}
    return {"num_steps_per_env": T, "save_interval": 5, "seed": 3, "obs_groups": obs_groups, "policy": policy,
            "algorithm": algorithm, **keys}


def _distill_cfg(**keys):
    return {"num_steps_per_env": 6, "save_interval": 5, "seed": 2,
            "obs_groups": {"policy": ["policy"], "teacher": ["privileged"]},
            "policy": {"class_name": "StudentTeacherRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                       "student_hidden_dims": [16], "teacher_hidden_dims": [16],
                       "student_obs_normalization": True, "teacher_obs_normalization": True},
            "algorithm": {"class_name": "Distillation", "gradient_length": 4, "max_grad_norm": 1.0}, **keys}


def _env(device="cpu", num_envs=N):
    return NLinkPendulum(num_envs, LINKS, max_episode_length=6, device=device)


def _dr_env(device="cpu"):
    return DomainRandomizedNLink(N, LINKS, max_episode_length=5, device=device)


def _state(runner) -> list[torch.Tensor]:
    """Everything a run carries between iterations: policy parameters and
    normalizer moments, Adam moments, count and learning rate (stacked for
    a study), the env state, obs, carries and episode sums."""
    if isinstance(runner, MultiSeedRunner):
        tree = (runner.train_state, runner.collect_state)
    else:
        alg = runner.alg
        tree = (alg.policy.state_dict(), alg.adam_mu, alg.adam_nu, alg.adam_count, alg.lr, runner.collect_state)
        if getattr(alg, "rnd", None) is not None:
            opt = alg.rnd_optimizer
            tree += (alg.rnd.state_dict(), opt.adam_mu, opt.adam_nu, opt.adam_count)
    return flatten(tree)[0]


def _assert_same_run(a, b):
    sa, sb = _state(a), _state(b)
    assert len(sa) == len(sb)
    for i, (x, y) in enumerate(zip(sa, sb)):
        assert torch.equal(x, y), f"state tensor {i} differs"
    assert [h["iteration"] for h in a.history] == [h["iteration"] for h in b.history]
    for ha, hb in zip(a.history, b.history):
        assert ha["metrics"].keys() == hb["metrics"].keys()
        for k in ha["metrics"]:
            np.testing.assert_array_equal(ha["metrics"][k], hb["metrics"][k], err_msg=k)


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    runner = OnPolicyRunner(_dr_env(), _cfg(recurrent=False, obs_groups={"policy": ["privileged"],
                                                                          "critic": ["privileged"]}),
                            device="cpu")
    runner.learn(1)
    path = str(tmp_path_factory.mktemp("teacher") / "model_0.pt")
    runner.save(path)
    return path


def _student(teacher_path, device="cpu", **keys):
    runner = DistillationRunner(_dr_env(device), _distill_cfg(**keys), device=device)
    runner.load(teacher_path)
    return runner


# ------------------------------------------------- K-dispatch against eager


@pytest.mark.parametrize("recurrent,rnd", [(True, False), (False, False), (True, True)],
                         ids=["recurrent", "feedforward", "recurrent_rnd"])
def test_k_dispatch_equals_fused_and_eager(recurrent, rnd):
    """7 iterations at K=3 (groups of 3, 3 and a remainder of 1) against 7
    fused iterations and 7 split ones (the JAX case
    ``tests/test_ppo_integration.py:212``)."""
    runs = {}
    for mode, keys in (("eager", {}), ("fused", {"fuse_iteration": True}), ("k3", {"iterations_per_dispatch": 3})):
        runs[mode] = OnPolicyRunner(_env(), _cfg(recurrent, rnd, **keys), device="cpu")
        runs[mode].learn(7)
    assert runs["k3"].fuse_iteration and not runs["eager"].fuse_iteration
    for mode in ("fused", "k3"):
        _assert_same_run(runs["eager"], runs[mode])
        assert runs[mode].current_learning_iteration == 6
        assert all(h["learn_s"] == 0.0 for h in runs[mode].history)
    assert int(runs["k3"].alg.adam_count) == 7 * 2 * 2  # iterations x epochs x minibatches
    if rnd:
        assert int(runs["k3"].alg.rnd.counter) == 7 * T and int(runs["k3"].alg.rnd_optimizer.adam_count) == 7 * 2 * 2


@pytest.mark.parametrize("optimizer", ["adamw", "sgd", "rmsprop"])
def test_optimizers_k_dispatch_equals_eager(optimizer):
    """Each optimizer's moments and count update in place: 3 iterations at
    K=2 equal 3 split ones bit for bit."""
    runs = []
    for keys in ({}, {"iterations_per_dispatch": 2}):
        cfg = _cfg(**keys)
        cfg["algorithm"] = dict(cfg["algorithm"], optimizer=optimizer)
        runs.append(OnPolicyRunner(_env(), cfg, device="cpu"))
        runs[-1].learn(3)
    _assert_same_run(*runs)


def test_study_k_dispatch_equals_eager():
    """A study of G=2 seeds, 5 iterations at K=2 (2 + 2 + 1) against 5 split
    ones (the JAX case ``tests/test_multiseed.py:384``)."""
    runs = [MultiSeedRunner(_env(), _cfg(**keys), G, device="cpu") for keys in ({}, {"iterations_per_dispatch": 2})]
    for runner in runs:
        runner.learn(5)
    _assert_same_run(*runs)
    assert runs[1].train_state.adam_count.tolist() == [5 * 2 * 2] * G


def test_distillation_k_dispatch_equals_eager(teacher_ckpt):
    runs = [_student(teacher_ckpt, **keys) for keys in ({}, {"iterations_per_dispatch": 2})]
    for runner in runs:
        runner.learn(3)
    _assert_same_run(*runs)


def test_fused_run_takes_what_is_assigned_between_learns(teacher_ckpt, tmp_path):
    """A checkpoint loaded, a collect state assigned, a generator reseeded and
    episode lengths scattered between two fused ``learn`` calls reach the
    next replays, as they reach the split run's next iterations."""
    donor = OnPolicyRunner(_env(), _cfg(), device="cpu")
    donor.learn(2)
    path = str(tmp_path / "model_1.pt")
    donor.save(path)
    runs = [OnPolicyRunner(_env(), _cfg(**keys), device="cpu") for keys in ({}, {"iterations_per_dispatch": 2})]
    for runner in runs:
        runner.learn(3)
        runner.load(path)
        runner.collect_state = copy.deepcopy(donor.collect_state)
        runner.alg.generator.manual_seed(11)
        runner.learn(2, init_at_random_ep_len=True)
    _assert_same_run(*runs)
    assert runs[1].current_learning_iteration == 2  # the loaded iteration 1, then 1 and 2


@pytest.mark.parametrize("kind", ["ppo", "study", "distillation", "ppo_rnd"])
def test_iteration_keeps_every_state_tensor_in_place(kind, teacher_ckpt):
    """An iteration updates the optimizer state (Adam moments and count, the
    learning rate), the parameters and the normalizer moments in place, and
    the fused iteration its static state tree: no ``data_ptr`` changes (a
    CUDA graph replays these addresses)."""
    if kind == "study":
        runner = MultiSeedRunner(_env(), _cfg(fuse_iteration=True), G, device="cpu")
        runner.learn(1)
        held = flatten(runner.train_state)[0]
    else:
        runner = (_student(teacher_ckpt, fuse_iteration=True) if kind == "distillation"
                  else OnPolicyRunner(_env(), _cfg(rnd=kind == "ppo_rnd", fuse_iteration=True), device="cpu"))
        runner.learn(1)
        alg = runner.alg
        held = [*alg.params, *alg.adam_mu, *alg.adam_nu, alg.adam_count, alg.lr, *alg.policy.buffers()]
        if kind == "ppo_rnd":
            # the predictor, its Adam moments and count, both normalizers, the counter
            opt = alg.rnd_optimizer
            held += [*alg.rnd.buffers(), *opt.params, *opt.adam_mu, *opt.adam_nu, opt.adam_count]
    held += flatten(runner.iteration_graph.state)[0]
    before = [t.data_ptr() for t in held]
    snapshot = [t.detach().clone() for t in held]
    runner.learn(2)
    assert [t.data_ptr() for t in held] == before
    assert not all(torch.equal(a, b) for a, b in zip(held, snapshot))  # the iterations did change them
    state = flatten(runner.iteration_graph.state)[0]
    assert [t.data_ptr() for t in state] == before[len(before) - len(state):]


def test_iteration_graph_load_copies_into_its_own_tensors():
    """``load`` takes a private copy first, then copies what differs; a tree
    of other shapes is refused."""
    tree = {"a": torch.zeros(3), "b": (torch.ones(2),)}
    graph = IterationGraph(lambda t: (t, {}), torch.device("cpu"))
    graph.load(tree)
    static = flatten(graph.state)[0]
    assert all(s.data_ptr() != t.data_ptr() for s, t in zip(static, flatten(tree)[0]))
    graph.load({"a": torch.arange(3.0), "b": graph.state["b"]})
    assert torch.equal(graph.state["a"], torch.arange(3.0)) and graph.state["a"].data_ptr() == static[0].data_ptr()
    with pytest.raises(ValueError, match="shapes"):
        graph.load({"a": torch.zeros(4), "b": (torch.ones(2),)})


# ------------------------------------------------------ keys and refusals


@pytest.mark.parametrize("runner_kind", ["ppo", "study"])
@pytest.mark.parametrize("key,value", [("eval_interval", 10), ("model_parallel_size", 2)])
def test_unported_keys_raise_in_every_runner(runner_kind, key, value):
    """The runner keys once refused, in every runner. ``eval_interval`` is
    taken by both (and warns without a log_dir). ``model_parallel_size: 2``
    raises ``ValueError("must divide")`` in ``OnPolicyRunner`` on one
    process, as the JAX runner does; ``MultiSeedRunner`` ignores the key, as
    the JAX one (which never reads it) does, and trains."""
    make = ((lambda cfg: OnPolicyRunner(_env(), cfg, device="cpu")) if runner_kind == "ppo"
            else (lambda cfg: MultiSeedRunner(_env(), cfg, G, device="cpu")))
    if key == "eval_interval":
        with pytest.warns(UserWarning, match="eval_interval"):
            assert make(_cfg(**{key: value})).eval_interval == value
        return
    if runner_kind == "ppo":
        with pytest.raises(ValueError, match="must divide"):
            make(_cfg(**{key: value}))
        return
    runner = make(_cfg(**{key: value}))
    assert runner.mesh is None
    runner.learn(1)
    assert len(runner.history) == 1


def test_log_dir_needs_save_interval_and_positive_k(tmp_path):
    cfg = _cfg()
    del cfg["save_interval"]
    with pytest.raises(ValueError, match="save_interval"):
        OnPolicyRunner(_env(), cfg, log_dir=str(tmp_path), device="cpu")
    OnPolicyRunner(_env(), cfg, device="cpu")  # no log_dir, no saves
    with pytest.raises(ValueError, match="iterations_per_dispatch"):
        OnPolicyRunner(_env(), _cfg(iterations_per_dispatch=0), device="cpu")


def test_log_dir_without_tensorboardx_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    runner = OnPolicyRunner(_env(), _cfg(), log_dir=str(tmp_path), device="cpu")
    with pytest.raises(ImportError, match="tensorboardX"):
        runner.learn(1)


# ------------------------------------------- log and save contract vs JAX


def _record_scalars(monkeypatch, writer_cls, out: list):
    real = writer_cls.add_scalar

    def add_scalar(self, tag, value, step):
        out.append((tag, step))
        real(self, tag, value, step)

    monkeypatch.setattr(writer_cls, "add_scalar", add_scalar)


def _ckpt_iterations(log_dir):
    return sorted(int(f.split("_")[1].split(".")[0]) for f in os.listdir(log_dir) if f.startswith("model_"))


@pytest.mark.parametrize("kind", ["ppo", "study"])
def test_k_dispatch_log_and_save_contract_matches_jax(kind, tmp_path, monkeypatch):
    """8 iterations at K=4 with ``save_interval=5`` (``study``: 6 at K=3 with
    ``save_interval=4``, the JAX cases ``tests/test_ppo_integration.py:227``
    and ``tests/test_multiseed.py:395``): both packages log every iteration
    under the same tags, save at the same group boundaries (iteration 5 falls
    in the last group, saved at its end) and count the same steps."""
    from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
    from rsl_rl_tpu.runners import MultiSeedRunner as JaxMultiSeedRunner
    from rsl_rl_tpu.runners import OnPolicyRunner as JaxRunner
    from rsl_rl_tpu.utils import writers as jax_writers
    from rsl_rl_tpu_torch.utils import writers

    iterations, k, save_interval = (8, 4, 5) if kind == "ppo" else (6, 3, 4)
    cfg = _cfg(recurrent=False, iterations_per_dispatch=k, save_interval=save_interval, logger="tensorboard")
    logged = {"jax": [], "port": []}
    _record_scalars(monkeypatch, jax_writers.TensorBoardWriter, logged["jax"])
    _record_scalars(monkeypatch, writers.TensorBoardWriter, logged["port"])
    dirs = {name: str(tmp_path / name) for name in logged}
    if kind == "ppo":
        runners = {"jax": JaxRunner(JaxNLink(N, LINKS, max_episode_length=6), copy.deepcopy(cfg), log_dir=dirs["jax"]),
                   "port": OnPolicyRunner(_env(), copy.deepcopy(cfg), log_dir=dirs["port"], device="cpu")}
    else:
        runners = {"jax": JaxMultiSeedRunner(JaxNLink(N, LINKS, max_episode_length=6), copy.deepcopy(cfg), G,
                                             log_dir=dirs["jax"]),
                   "port": MultiSeedRunner(_env(), copy.deepcopy(cfg), G, log_dir=dirs["port"], device="cpu")}
    for runner in runners.values():
        runner.learn(iterations)
    jax_run, port_run = runners["jax"], runners["port"]
    assert port_run.current_learning_iteration == jax_run.current_learning_iteration == iterations - 1
    assert port_run.tot_timesteps == jax_run.tot_timesteps
    assert _ckpt_iterations(dirs["port"]) == _ckpt_iterations(dirs["jax"]) == [k - 1, iterations - 1]
    for d in dirs.values():
        assert any(f.startswith("events.out.tfevents") for f in os.listdir(d))
    # steps of the wall-clock tags are times; their tags must still agree
    by_step = {name: sorted((t, s) for t, s in rows if not t.endswith("/time")) for name, rows in logged.items()}
    assert by_step["port"] == by_step["jax"]
    assert sorted({t for t, _ in logged["port"]}) == sorted({t for t, _ in logged["jax"]})
    assert sorted({s for _, s in by_step["port"]}) == list(range(iterations))
    assert [h["iteration"] for h in port_run.history] == list(range(iterations))


def test_study_writes_cross_seed_scalars_and_saves(tmp_path):
    runner = MultiSeedRunner(_env(), _cfg(save_interval=2), G, log_dir=str(tmp_path), device="cpu")
    runner.learn(3)
    assert _ckpt_iterations(str(tmp_path)) == [0, 2]
    assert runner.tot_timesteps == 3 * T * N * G


# ----------------------------------------------- git state and the profiler


def _tracked_file(tmp_path):
    """A file of a fresh git repo ``tracked`` with an uncommitted change."""
    repo = tmp_path / "tracked"
    repo.mkdir()
    (repo / "code.py").write_text("x = 1\n")
    git = ["git", "-C", str(repo), "-c", "user.name=t", "-c", "user.email=t@t"]
    for args in (["init", "-q"], ["add", "code.py"], ["commit", "-q", "-m", "c"]):
        subprocess.run(git + args, check=True, capture_output=True)
    (repo / "code.py").write_text("x = 2\n")
    return str(repo / "code.py")


def test_git_state_lands_in_log_dir(tmp_path):
    log_dir = tmp_path / "run"
    runner = OnPolicyRunner(_env(), _cfg(), log_dir=str(log_dir), device="cpu")
    runner.add_git_repo_to_log(_tracked_file(tmp_path))
    runner.learn(1)
    diff = (log_dir / "git" / "tracked.diff").read_text()
    assert "--- git status ---" in diff and "+x = 2" in diff


@pytest.mark.parametrize("runner_kind", ["ppo", "study"])
def test_wandb_logger_uploads_config_models_and_git_state(tmp_path, monkeypatch, runner_kind):
    """``logger="wandb"`` (a stand-in module here): the config is uploaded
    when the writer starts, every scalar dual-written, every saved model and
    the git diff uploaded, as in the JAX package."""
    mod = types.ModuleType("wandb")
    mod.logged, mod.saved = [], []
    mod.run = types.SimpleNamespace(name="run-1")
    mod.config = types.SimpleNamespace(update=lambda d: mod.logged.append(("config", d)))
    mod.init = lambda **kw: mod.logged.append(("init", kw))
    mod.log = lambda d, step=None: mod.logged.append(("log", d, step))
    mod.save = lambda path, base_path=None: mod.saved.append(path)
    monkeypatch.setitem(sys.modules, "wandb", mod)
    cfg = _cfg(logger="wandb", wandb_project="proj", save_interval=1)
    log_dir = str(tmp_path / "run")
    runner = (OnPolicyRunner(_env(), cfg, log_dir=log_dir, device="cpu") if runner_kind == "ppo"
              else MultiSeedRunner(_env(), cfg, G, log_dir=log_dir, device="cpu"))
    runner.add_git_repo_to_log(_tracked_file(tmp_path))
    runner.learn(2)
    assert any(e[0] == "config" for e in mod.logged)
    assert {e[2] for e in mod.logged if e[0] == "log" and "Perf/total_fps" in e[1]} == {0, 1}
    assert {os.path.basename(p) for p in mod.saved} >= {"model_0.pt", "model_1.pt", "tracked.diff"}


@pytest.mark.parametrize("k", [1, 2])
def test_profiler_window_writes_trace_and_tolerates_a_resume(tmp_path, k):
    """``profiler_trace_iterations = [1, 2]`` writes a trace under
    ``<log_dir>/profile``; a run resumed at iteration 2 (past the start)
    starts no trace and stops none."""
    log_dir = str(tmp_path)
    cfg = _cfg(profiler_trace_iterations=[1, 2], save_interval=2, iterations_per_dispatch=k)
    runner = OnPolicyRunner(_env(), cfg, log_dir=log_dir, device="cpu")
    runner.learn(3)
    traces = os.listdir(os.path.join(log_dir, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    resumed = OnPolicyRunner(_env(), cfg, log_dir=log_dir, device="cpu")
    assert resumed.load_latest()
    assert resumed.current_learning_iteration == 2
    resumed.learn(2)
    assert os.listdir(os.path.join(log_dir, "profile")) == traces


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ppo_gru", "ppo_ff", "study", "distillation", "ppo_rnd"])
def test_graph_replays_equal_eager_on_card(kind, tmp_path):
    """On the card a fused run replays a captured graph: 3 iterations at K=2
    (warm-up and capture, a replay, a remainder replay) equal 3 split
    iterations bit for bit, with the same kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    teacher_path = None
    if kind == "distillation":
        teacher = OnPolicyRunner(_dr_env("cuda"), _cfg(recurrent=False, obs_groups={"policy": ["privileged"],
                                                                                  "critic": ["privileged"]}),
                                 device="cuda")
        teacher.learn(1)
        teacher_path = str(tmp_path / "model_0.pt")
        teacher.save(teacher_path)

    def make(keys):
        if kind == "study":
            return MultiSeedRunner(_env("cuda"), _cfg(**keys), G, device="cuda")
        if kind == "distillation":
            return _student(teacher_path, "cuda", **keys)
        return OnPolicyRunner(_env("cuda"), _cfg(kind != "ppo_ff", kind == "ppo_rnd", **keys), device="cuda")

    runs, counts = [], []
    for keys in ({}, {"iterations_per_dispatch": 2}):
        for counter in cuda_graph.launch_counters():
            counter.reset()
        runner = make(keys)
        runner.learn(3)
        torch.cuda.synchronize()
        runs.append(runner)
        counts.append([vars(c).copy() for c in cuda_graph.launch_counters()])
    _assert_same_run(*runs)
    assert counts[0] == counts[1]
    graph = runs[1].iteration_graph
    assert graph.capture_s is not None and graph.pool_bytes >= 0


@pytest.mark.cuda
def test_a_dropped_fused_runner_does_not_break_the_next_capture():
    """A fused runner dropped without releasing its graph (it lives on in a
    reference cycle until the cyclic collector runs) must not free its graph
    inside the next runner's capture: the second fused run captures and
    trains."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import gc

    threshold = gc.get_threshold()
    gc.set_threshold(1)  # collect as often as the collector may
    try:
        for _ in range(3):
            runner = OnPolicyRunner(_env("cuda"), _cfg(fuse_iteration=True), device="cuda")
            runner.learn(2)
            assert runner.iteration_graph.capture_s is not None
    finally:
        gc.set_threshold(*threshold)
