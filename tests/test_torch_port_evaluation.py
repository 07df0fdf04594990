"""The port's deterministic evaluation (``utils/evaluation.py``) against the
JAX package's ``make_eval_program``, and the runners' ``eval_interval``
(``Eval/*`` scalars, the no-``log_dir`` warning, evaluation at the end of a
K-dispatch group, training left as it was, the study's vmapped evaluation).

The env's reset draws differ between the frameworks (threefry against
splitmix64), so the parity test hands the port the JAX program's own reset
state; its envs complete one episode each (time-outs at step 10 of a
15-step budget), all from that state. Tolerance rtol 1e-5 / atol 1e-5 (fp32
in another summation order).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from rsl_rl_tpu.env.nlink import NLinkPendulum as JaxNLink
from rsl_rl_tpu.modules import ActorCritic as JaxAC
from rsl_rl_tpu.modules import ActorCriticRecurrent as JaxACR
from rsl_rl_tpu.utils.evaluation import make_eval_program as jax_make_eval_program
from rsl_rl_tpu_torch.env import NLinkPendulum, PointMass
from rsl_rl_tpu_torch.env.nlink import NLinkState, env_keys
from rsl_rl_tpu_torch.modules import ActorCritic, ActorCriticRecurrent
from rsl_rl_tpu_torch.runners import MultiSeedRunner, OnPolicyRunner
from rsl_rl_tpu_torch.utils.evaluation import EVAL_KEYS, eval_seed, evaluate_policy, make_eval_program
from rsl_rl_tpu_torch.utils.weights import from_jax_state

N, LINKS = 16, 3
GROUPS = {"policy": ["policy"], "critic": ["policy"]}
MLP_KW = dict(actor_hidden_dims=[16, 16], critic_hidden_dims=[16, 16], actor_obs_normalization=True,
              critic_obs_normalization=True)
POLICIES = {"feedforward": (JaxAC, ActorCritic, MLP_KW),
            "gru": (JaxACR, ActorCriticRecurrent, dict(MLP_KW, rnn_type="gru", rnn_hidden_dim=16))}


def _t(x):
    return torch.tensor(np.asarray(x))


class _GivenReset(NLinkPendulum):
    """The port's NLink env whose reset returns a given state and obs."""

    given = None

    def reset(self, seed=0, num_envs=None):
        return self.given


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_eval_metrics_match_jax(name):
    """Every ``Eval/*`` metric of the port's program against the JAX
    program's, from the same policy (normalizer moments included) and the
    same reset state."""
    jcls, cls, kw = POLICIES[name]
    jenv = JaxNLink(N, LINKS, max_episode_length=10)
    key = jax.random.PRNGKey(3)
    state, obs = jenv.reset(jax.random.split(key)[0])  # the program's reset
    jpolicy = jcls(obs, GROUPS, LINKS, **kw)
    ps = jpolicy.update_normalization(jpolicy.init(jax.random.PRNGKey(4)), obs)
    want = jax.device_get(jax.jit(jax_make_eval_program(jenv, jpolicy, 15))(ps, key))

    tobs = {k: _t(v) for k, v in obs.items()}
    policy = cls(tobs, GROUPS, LINKS, device="cpu", **kw)
    ps = jax.device_get(ps)
    norm = {r: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
            for r, v in ps.norm.items()}
    from_jax_state(ps.params, norm, policy)
    env = _GivenReset(N, LINKS, max_episode_length=10, device="cpu")
    env.given = (NLinkState(_t(state.episode_length), _t(state.theta), _t(state.omega), env_keys(0, N)), tobs)
    got = evaluate_policy(env, policy, None, 15, seed=0)
    assert want["Eval/episode_count"] == N == got["Eval/episode_count"]
    for k in EVAL_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def _cfg(**keys):
    return {"num_steps_per_env": 8, "save_interval": 100, "seed": 1, "obs_groups": GROUPS,
            "policy": {"class_name": "ActorCriticRecurrent", "rnn_type": "gru", "rnn_hidden_dim": 8,
                       "actor_hidden_dims": [8], "critic_hidden_dims": [8]},
            "algorithm": {"class_name": "PPO", "num_learning_epochs": 1, "num_mini_batches": 2}, **keys}


def _state(runner):
    alg = runner.alg
    return [t.detach().clone() for t in (*alg.policy.state_dict().values(), *alg.adam_mu, alg.lr,
                                         alg.generator.get_state(), runner.collect_state.obs["policy"],
                                         *runner.collect_state.carry["actor"])]


def test_deterministic_and_leaves_training_alone():
    """Two evaluations from one seed agree; another seed rolls other envs;
    the training state (parameters, optimizer, generator, env state, carries)
    is as it was; random actions give a baseline of their own."""
    runner = OnPolicyRunner(PointMass(8, max_episode_length=16, device="cpu"), _cfg(), device="cpu")
    runner.learn(1)
    before = _state(runner)
    a = evaluate_policy(runner.env, runner.alg.policy, None, 16, seed=7)
    b = evaluate_policy(runner.env, runner.alg.policy, None, 16, seed=7)
    c = evaluate_policy(runner.env, runner.alg.policy, None, 16, seed=8)
    rand = evaluate_policy(runner.env, runner.alg.policy, None, 16, seed=7, random_actions=True)
    assert a == b and a["Eval/episode_count"] == 8 and a != c
    assert rand["Eval/episode_count"] == 8 and rand["Eval/mean_reward"] != a["Eval/mean_reward"]
    assert all(torch.equal(x, y) for x, y in zip(before, _state(runner)))
    assert eval_seed(1, 0) != eval_seed(1, 1) and eval_seed(1, 0) != 1


class _Writer:
    def __init__(self):
        self.tags = {}

    def add_scalar(self, tag, value, step):
        self.tags.setdefault(tag, []).append((step, value))

    def flush(self):
        pass


def _runner(tmp_path, **keys):
    tmp_path.mkdir(exist_ok=True)  # the stand-in writer makes no directory
    runner = OnPolicyRunner(PointMass(8, max_episode_length=16, device="cpu"), _cfg(**keys), log_dir=str(tmp_path),
                            device="cpu")
    runner.writer = _Writer()
    return runner


@pytest.mark.parametrize("keys,steps", [({}, [0, 2]), ({"iterations_per_dispatch": 2}, [1, 3])],
                         ids=["split", "k2"])
def test_eval_scalars_at_interval_and_group_boundary(tmp_path, keys, steps):
    """``eval_interval=2`` writes every ``Eval/*`` scalar at iterations 0 and
    2; under K=2 dispatch at the end of each group holding one (1 and 3), as
    the JAX runner does. The budget defaults to the longest episode, so
    each of the 8 envs completes one."""
    runner = _runner(tmp_path, eval_interval=2, **keys)
    runner.learn(4)
    tags = runner.writer.tags
    for key in EVAL_KEYS:
        assert [s for s, _ in tags[key]] == steps, key
    assert all(v == 8.0 for _, v in tags["Eval/episode_count"])


def test_eval_does_not_perturb_training(tmp_path):
    """A run evaluating every iteration trains as one without evaluation,
    bit for bit (JAX ``test_eval_does_not_perturb_training``)."""
    plain = _runner(tmp_path / "a")
    plain.learn(2)
    with_eval = _runner(tmp_path / "b", eval_interval=1)
    with_eval.learn(2)
    assert "Eval/mean_reward" in with_eval.writer.tags
    for x, y in zip(_state(plain), _state(with_eval)):
        assert torch.equal(x, y)


def test_eval_without_log_dir_warns():
    with pytest.warns(UserWarning, match="eval_interval is set but log_dir is None"):
        runner = OnPolicyRunner(PointMass(8, device="cpu"), _cfg(eval_interval=1), device="cpu")
    assert runner.eval_num_steps == 100  # the env's episode length
    runner.learn(1)  # and no evaluation runs


def test_study_eval_is_each_seed_eval(tmp_path):
    """The study's batched evaluation: seed 0 rolls the first ``num_envs``
    envs of the reset, so it equals seed 0's own single-seed evaluation;
    the runner writes the cross-seed mean, spread and best."""
    cfg = _cfg(eval_interval=2)
    study = MultiSeedRunner(PointMass(8, max_episode_length=16, device="cpu"), cfg, 2, log_dir=str(tmp_path),
                            device="cpu")
    study.writer = _Writer()
    study.learn(3)
    ts = study.train_state
    stacked = evaluate_policy(study.env, study.alg.policy, (ts.params, ts.buffers), 16, seed=5, num_seeds=2)
    policy = copy.deepcopy(study.alg.policy)
    with torch.no_grad():
        for name, p in policy.named_parameters():
            p.copy_(ts.params[name][0])
        for name, b in policy.named_buffers():
            b.copy_(ts.buffers[name][0])
    single = evaluate_policy(study.env, policy, None, 16, seed=5)
    for k in EVAL_KEYS:
        np.testing.assert_allclose(stacked[k][0], single[k], rtol=1e-6, err_msg=k)
    assert stacked["Eval/mean_reward"][0] != stacked["Eval/mean_reward"][1]
    tags = study.writer.tags
    assert [s for s, _ in tags["Eval/mean_reward"]] == [0, 2]
    assert {"Eval/mean_reward_std", "Eval/best_seed_reward", "Eval/mean_episode_length"} <= set(tags)
    assert all(v == 16.0 for _, v in tags["Eval/episode_count"])


def test_program_is_reusable():
    """``make_eval_program`` builds once and runs for any state and seed."""
    env = PointMass(4, max_episode_length=5, device="cpu")
    _, obs = env.reset(0)
    policy = ActorCritic(obs, GROUPS, 1, device="cpu", actor_hidden_dims=[4], critic_hidden_dims=[4])
    program = make_eval_program(env, policy, 5)
    state = (dict(policy.named_parameters()), dict(policy.named_buffers()))
    first, again = program(state, 1), program(None, 1)
    assert all(torch.equal(first[k], again[k]) for k in EVAL_KEYS)
