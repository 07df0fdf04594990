"""The port's feedforward PPO on the NLink parity protocol, driven by the JAX
package's own random streams.

    JAX_PLATFORMS=cpu python tests/torch_port_stream_parity.py --seeds 1 2 3 [--iterations 500] [--out FILE]

Each seed is one single-seed run of ``benchmarks/parity_nlink.py``'s
protocol (``benchmarks/parity_pendulum.py``'s ``train_cfg``, 64
``NLinkPendulum`` envs of 5 links, ``max_episode_length=400``): the JAX
``OnPolicyRunner`` for that seed gives the initial policy, env state and
keys, and the port (on the CPU) trains from them with every random draw
taken from the JAX runner's streams: the action noise of each step (the
collect's key chain), the permutation of each update, and the reset draws
of each env (its key chain in the env state). The script prints, per seed,
the final (the nan-aware mean of the last 20 iterations' mean reward) and
writes the curves to ``--out``. With the JAX draws the port computes the
JAX run's numbers until fp32 rounding, amplified by the dynamics, separates
the two; ``tests/test_torch_port_ff.py`` holds the first iterations.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from benchmarks.parity_pendulum import train_cfg  # noqa: E402
from rsl_rl_tpu.env import NLinkPendulum as JaxNLink  # noqa: E402
from rsl_rl_tpu.runners import OnPolicyRunner as JaxRunner  # noqa: E402
from rsl_rl_tpu_torch.algorithms.ppo import PPO, CollectState, init_episode_stats  # noqa: E402
from rsl_rl_tpu_torch.env.nlink import NLinkPendulum, NLinkState, env_keys  # noqa: E402
from rsl_rl_tpu_torch.modules import ActorCritic  # noqa: E402
from rsl_rl_tpu_torch.utils.weights import from_jax_state  # noqa: E402

NUM_ENVS, NUM_LINKS, T, MAX_EPISODE_LENGTH = 64, 5, 24, 400


def _t(x):
    return torch.tensor(np.asarray(x))


def stream_run(seed: int, iterations: int, max_episode_length: int = MAX_EPISODE_LENGTH):
    """The port's curve (one mean completed-episode reward an iteration, nan
    where none completed) and per-iteration metrics, with the JAX run's
    streams, and the JAX runner it started from."""
    jenv = JaxNLink(num_envs=NUM_ENVS, num_links=NUM_LINKS, max_episode_length=max_episode_length)
    jax_runner = JaxRunner(jenv, train_cfg(seed), log_dir=None)
    ts, cs = jax_runner.train_state, jax_runner.collect_state
    cfg = train_cfg(seed)
    policy_kw = {k: v for k, v in cfg["policy"].items() if k != "class_name"}
    alg_kw = {k: v for k, v in cfg["algorithm"].items() if k != "class_name"}
    policy = ActorCritic({k: _t(v) for k, v in cs.obs.items()}, cfg["obs_groups"], NUM_LINKS, device="cpu",
                         **policy_kw)
    ps = jax.device_get(ts.policy)
    norm = {k: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
            for k, v in ps.norm.items()}
    from_jax_state(ps.params, norm, policy)
    ppo = PPO(policy, **alg_kw)
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, max_episode_length=max_episode_length, device="cpu")
    fresh = []  # the JAX env's reset draws, one entry a step
    env._sample_init = lambda rng: (rng, fresh.pop(0))
    st = jax.device_get(cs.env_state)
    port_cs = CollectState(env_state=NLinkState(_t(st.episode_length), _t(st.theta), _t(st.omega),
                                                env_keys(0, NUM_ENVS)),
                           obs={k: _t(v) for k, v in cs.obs.items()}, carry=(),
                           stats=init_episode_stats(NUM_ENVS, "cpu"))

    @jax.jit
    def reset_draws(rng):
        # the JAX env's step splits each env's key every step, reset or not
        keys = jax.vmap(jax.random.split, in_axes=0, out_axes=1)(rng)
        theta, omega = jax.vmap(lambda k: tuple(x[0] for x in jenv._sample_init(k, 1)))(keys[1])
        return keys[0], theta, omega

    split = jax.jit(jax.random.split)
    normal = jax.jit(lambda k: jax.random.normal(k, (NUM_ENVS, NUM_LINKS)))
    permutation = jax.jit(lambda k: jax.random.permutation(k, T * NUM_ENVS))
    key, env_rng = ts.rng, cs.env_state.rng
    curve, history = [], []
    for _ in range(iterations):
        noise = []
        for _ in range(T):  # the collect's key chain
            key, k_act = split(key)
            noise.append(np.asarray(normal(k_act)))
            env_rng, theta, omega = reset_draws(env_rng)
            fresh.append({"theta": _t(theta), "omega": _t(omega)})
        key, k_perm = split(key)  # the update's draw
        port_cs, rollout, cm = ppo.collect(env, port_cs, T, action_noise=torch.tensor(np.stack(noise)))
        port_cs, um = ppo.update(port_cs, rollout, perm=_t(permutation(k_perm)))
        count = float(cm["ep_count"])
        curve.append(float(cm["ep_reward_sum"]) / count if count > 0 else float("nan"))
        history.append({k: float(v) for k, v in {**cm, **um}.items()})
    return curve, history, jax_runner


def final(curve) -> float:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(np.asarray(curve[-20:], np.float64)))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    torch.set_num_threads(2)
    out = {}
    for seed in args.seeds:
        curve, _, _ = stream_run(seed, args.iterations)
        out[seed] = {"final": final(curve), "curve": [None if np.isnan(v) else v for v in curve]}
        print(json.dumps({"seed": seed, "final": out[seed]["final"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
