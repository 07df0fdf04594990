"""The port's population-based training (``runners/pbt.py`` and
``MultiSeedRunner(pbt=...)``): the cases of the JAX package's
``tests/test_pbt.py`` on the port, and the exchange against the JAX
package's with its choices injected.

Random streams differ between the frameworks (the JAX exchange draws from
threefry), so the exchange test reads JAX's choices off a JAX step (which
seed each replaced seed copied, and the factor its learning rate took) and
hands them to the port's exchange, from the same pre-exchange state.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from rsl_rl_tpu.algorithms.ppo import PPO as JaxPPO
from rsl_rl_tpu.env import Pendulum as JaxPendulum
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.runners.pbt import make_pbt_train as jax_make_pbt_train
from rsl_rl_tpu_torch.algorithms.ppo import PPO
from rsl_rl_tpu_torch.env import Pendulum
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent
from rsl_rl_tpu_torch.runners import MultiSeedRunner, make_pbt_train
from rsl_rl_tpu_torch.runners.multiseed_runner import seed_sequence
from rsl_rl_tpu_torch.runners.pbt import exploit, init_pbt_state, make_pbt_step
from rsl_rl_tpu_torch.utils.weights import from_jax_stacked_state

N, T = 8, 8
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
POLICY_KW = dict(actor_hidden_dims=[16], critic_hidden_dims=[16])
PPO_KW = dict(schedule="adaptive", desired_kl=0.01, num_learning_epochs=2, num_mini_batches=2)


def _make(num_seeds, episode_len=8, variant="feedforward", **pbt):
    """``(init, train_step, policies)`` of a port PBT study on 8 ``Pendulum``
    envs a seed, with short episodes so fitness turns valid fast."""
    env = Pendulum(N, max_episode_length=episode_len, device="cpu")
    _, obs = env.reset(0)
    groups, rnd_cfg = dict(GROUPS), None
    if variant == "rnd":
        groups["rnd_state"] = ["policy"]
        rnd_cfg = {"num_states": 3, "obs_groups": groups, "num_outputs": 4, "predictor_hidden_dims": [8],
                   "target_hidden_dims": [8], "weight": 0.5, "reward_normalization": True}
    if variant == "recurrent":
        policies = [ActorCriticRecurrent(obs, groups, 1, rnn_type="gru", rnn_hidden_dim=8, device="cpu", seed=s,
                                         **POLICY_KW) for s in seed_sequence(1, num_seeds)]
    else:
        policies = [ActorCritic(obs, groups, 1, device="cpu", seed=s, **POLICY_KW) for s in seed_sequence(1, num_seeds)]
    alg = PPO(policies[0], rnd_cfg=rnd_cfg, seed=2, **PPO_KW)
    init, train_step = make_pbt_train(alg, env, T, num_seeds, device="cpu", **pbt)
    return init, train_step, policies


def _seed_equal(ts, i, j) -> bool:
    return all(torch.equal(v[i], v[j]) for v in ts.params.values())


def test_zero_fraction_disables_exchange():
    init, train_step, policies = _make(3, exploit_interval=1, exploit_fraction=0.0)
    ts, cs, pbt = init(policies, 0)
    for _ in range(3):
        ts, cs, pbt, metrics = train_step(ts, cs, pbt)
    assert int(metrics["PBT/exploits"]) == 0 and metrics["PBT/exploits"].shape == ()
    assert metrics["PBT/fitness"].shape == (3,) and torch.isfinite(metrics["PBT/fitness"]).all()
    assert torch.isfinite(metrics["Loss/value_function"]).all()


@pytest.mark.parametrize("variant", ["feedforward", "recurrent", "rnd"])
def test_exploit_clones_a_top_member_and_perturbs_lr(variant):
    """Iteration 1 completes every seed's episodes (episode length = window),
    so the exchange fires: exactly one pair of seeds holds equal parameters
    (the clone and its source, RND state and optimizer state included), the
    clone's learning rate is the source's times a factor in [0.8, 1.25]."""
    num_seeds = 4
    init, train_step, policies = _make(num_seeds, variant=variant, exploit_interval=1, exploit_fraction=0.25,
                                       lr_perturb=(0.8, 1.25))
    ts, cs, pbt = init(policies, 1)
    ts, cs, pbt, metrics = train_step(ts, cs, pbt)
    assert int(metrics["PBT/exploits"]) == 1
    clones = [(i, j) for i in range(num_seeds) for j in range(i + 1, num_seeds) if _seed_equal(ts, i, j)]
    assert len(clones) == 1, f"expected exactly one cloned pair, got {clones}"
    i, j = clones[0]
    for tree in (ts.adam_mu, ts.adam_nu, *(() if ts.rnd_params is None else (ts.rnd_params, ts.rnd_buffers))):
        assert all(torch.equal(v[i], v[j]) for v in tree.values())
    ratio = float(ts.lr[i] / ts.lr[j])
    assert ratio != 1.0, "cloned learning rate was not perturbed"
    assert 0.8 <= min(ratio, 1.0 / ratio) and max(ratio, 1.0 / ratio) <= 1.25
    assert torch.equal(metrics["PBT/lr"], ts.lr)


def test_overlapping_pools_rejected():
    """exploit_fraction > 0.5 would let replaced losers serve as clone
    sources; construction refuses."""
    with pytest.raises(ValueError, match="exploit_fraction"):
        _make(4, exploit_fraction=0.75)


def test_exchange_waits_for_valid_fitness():
    """32-step episodes against 8-step windows: no seed finishes an episode
    in the first iteration, so the (due) exchange holds off."""
    init, train_step, policies = _make(4, episode_len=32, exploit_interval=1, exploit_fraction=0.25)
    ts, cs, pbt = init(policies, 2)
    before = copy.deepcopy(ts.params)
    ts, cs, pbt, metrics = train_step(ts, cs, pbt)
    assert int(metrics["PBT/exploits"]) == 0 and not pbt.fitness_valid.any()
    assert not any(_seed_equal(ts, i, j) for i in range(4) for j in range(i + 1, 4))
    assert before.keys() == ts.params.keys()


def test_exchange_matches_jax_with_its_choices_injected():
    """From the same pre-exchange state, the port's fitness update equals
    JAX's, and its exchange, given the choices JAX made (the top member
    each bottom seed copied, the factor of its learning rate), leaves every
    seed's parameters, normalizer moments, learning rate and fitness as the
    JAX exchange does, and counts the exploits."""
    num_seeds, k = 4, 2
    env = JaxPendulum(num_envs=N, max_episode_length=8)
    _, obs = env.reset(jax.random.PRNGKey(0))
    alg = JaxPPO(JaxAC(obs, GROUPS, env.num_actions, **POLICY_KW), **PPO_KW)
    init, step_plain = jax_make_pbt_train(alg, env, T, num_seeds, exploit_interval=1, exploit_fraction=0.0)
    _, step_exch = jax_make_pbt_train(alg, env, T, num_seeds, exploit_interval=1, exploit_fraction=0.5)
    ts0, cs0, pbt0 = init(jax.random.PRNGKey(7))
    ts_a, _, pbt_a, m_a = step_plain(ts0, cs0, pbt0)
    ts_b, _, pbt_b, _ = step_exch(ts0, cs0, pbt0)
    ts_a, pbt_a, ts_b, pbt_b, m_a = jax.device_get((ts_a, pbt_a, ts_b, pbt_b, m_a))
    assert int(pbt_b.exploits) == k

    fitness = np.asarray(pbt_a.fitness)
    order = np.argsort(fitness, kind="stable")
    bottom, top = order[:k], order[num_seeds - k:]
    leaves_a = jax.tree_util.tree_leaves(ts_a.policy.params)
    leaves_b = jax.tree_util.tree_leaves(ts_b.policy.params)
    src = [next(s for s in range(num_seeds) if all(np.array_equal(lb[b], la[s]) for la, lb in zip(leaves_a, leaves_b)))
           for b in bottom]
    pick = [int(np.nonzero(top == s)[0][0]) for s in src]
    factors = np.ones(num_seeds, np.float32)
    factors[bottom] = np.asarray(ts_b.lr)[bottom] / np.asarray(ts_a.lr)[src]

    port_obs = {key: torch.tensor(np.asarray(v)) for key, v in obs.items()}
    template = ActorCritic(port_obs, GROUPS, 1, device="cpu", **POLICY_KW)
    ppo = PPO(template, **PPO_KW)

    def stacked(jts):
        ts = ppo.init_stacked_state([copy.deepcopy(template) for _ in range(num_seeds)], N)
        norm = {r: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
                for r, v in jts.policy.norm.items()}
        from_jax_stacked_state(jts.policy.params, norm, template, ts)
        ts.lr.copy_(torch.tensor(np.asarray(jts.lr)))
        return ts

    # the fitness update of the iteration (no exchange) from JAX's metrics
    pbt = init_pbt_state(num_seeds, 0, "cpu")
    metrics = {key: torch.tensor(np.asarray(m_a[key])) for key in ("ep_count", "ep_reward_sum")}
    out = make_pbt_step(num_seeds, exploit_interval=1, exploit_fraction=0.0)(stacked(ts_a), pbt, metrics)
    np.testing.assert_allclose(out["PBT/fitness"].numpy(), fitness, rtol=1e-6)
    assert bool(pbt.fitness_valid.all()) and int(pbt.it) == 1

    ts = stacked(ts_a)
    pbt.fitness.copy_(torch.tensor(fitness))
    exploit(ts, pbt, torch.tensor(True), k, (0.8, 1.25), choices=(pick, factors))
    want = stacked(ts_b)
    for name, v in ts.params.items():
        assert torch.equal(v, want.params[name]), name
    for name, v in ts.buffers.items():
        assert torch.equal(v, want.buffers[name]), name
    np.testing.assert_allclose(ts.lr.numpy(), np.asarray(ts_b.lr), rtol=1e-6)
    np.testing.assert_array_equal(pbt.fitness.numpy(), np.asarray(pbt_b.fitness))
    assert int(pbt.exploits) == k

    # not due: nothing moves
    before = [t.clone() for t in ts.seed_tensors()]
    exploit(ts, pbt, torch.tensor(False), k, (0.8, 1.25))
    assert all(torch.equal(a, b) for a, b in zip(before, ts.seed_tensors())) and int(pbt.exploits) == k


# ---------------------------------------------------------------- runner

CFG = {
    "num_steps_per_env": T,
    "save_interval": 2,
    "seed": 3,
    "obs_groups": GROUPS,
    "policy": {"class_name": "ActorCritic", **POLICY_KW},
    "algorithm": {"class_name": "PPO", **PPO_KW},
}
PBT = {"exploit_interval": 1, "exploit_fraction": 0.25}


def _runner(pbt=True, **keys):
    return MultiSeedRunner(Pendulum(N, max_episode_length=8, device="cpu"), {**copy.deepcopy(CFG), **keys}, 4,
                           device="cpu", pbt=dict(PBT) if pbt else None)


class _Writer:
    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append((step, value))

    def flush(self):
        pass


def test_learn_logs_pbt_scalars():
    runner = _runner()
    runner.writer = _Writer()
    runner.learn(3)
    assert int(runner.pbt_state.exploits) >= 1
    assert {"PBT/fitness_best", "PBT/fitness_median", "PBT/lr_min", "PBT/lr_max", "PBT/exploits"} <= set(
        runner.writer.tags)
    assert [s for s, _ in runner.writer.tags["PBT/exploits"]] == [0, 1, 2]
    assert runner.history[-1]["metrics"]["PBT/exploits"].shape == ()


def test_dispatched_study_equals_split_study():
    """The exchange inside the fused iteration (device-decided, no host
    read) and at K=2 gives the split run's state and metrics bit for bit."""
    runs = []
    for keys in ({}, {"iterations_per_dispatch": 2}):
        runner = _runner(**keys)
        runner.learn(3)
        runs.append(runner)
    a, b = runs
    assert int(a.pbt_state.exploits) >= 1
    for x, y in zip(a.train_state.seed_tensors(), b.train_state.seed_tensors()):
        assert torch.equal(x, y)
    for x, y in zip((a.pbt_state.fitness, a.pbt_state.it, a.pbt_state.exploits),
                    (b.pbt_state.fitness, b.pbt_state.it, b.pbt_state.exploits)):
        assert torch.equal(x, y)
    for ra, rb in zip(a.history, b.history):
        assert all(np.array_equal(ra["metrics"][k], rb["metrics"][k]) for k in ra["metrics"])


def test_resume_restores_pbt_state(tmp_path):
    runner = _runner()
    runner.learn(3)
    path = str(tmp_path / "snap.pt")
    runner.save(path)
    resumed = _runner()
    resumed.load(path)
    for key in ("fitness", "fitness_valid", "it", "exploits"):
        assert torch.equal(getattr(runner.pbt_state, key), getattr(resumed.pbt_state, key)), key
    assert torch.equal(runner.pbt_state.generator.get_state(), resumed.pbt_state.generator.get_state())
    for x, y in zip(runner.train_state.seed_tensors(), resumed.train_state.seed_tensors()):
        assert torch.equal(x, y)
    resumed.learn(1)  # and it keeps training
    assert resumed.history[-1]["metrics"]["PBT/fitness"].shape == (4,)


def test_mode_mismatch_rejected(tmp_path):
    runner = _runner()
    runner.learn(1)
    path = str(tmp_path / "snap.pt")
    runner.save(path)
    with pytest.raises(ValueError, match="PBT"):
        _runner(pbt=False).load(path)
    plain = _runner(pbt=False)
    plain.save(path)
    with pytest.raises(ValueError, match="PBT"):
        runner.load(path)
