"""The port's feedforward PPO on the NLink parity protocol, driven by the JAX
package's own random streams.

    JAX_PLATFORMS=cpu python tests/torch_port_stream_parity.py --seeds 1 2 3 [--iterations 500] [--out FILE]
        [--draws all|noise|perm|resets] [--init jax|port]
    JAX_PLATFORMS=cpu python tests/torch_port_stream_parity.py --summarize FILE [FILE ...] --out SUMMARY

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

``--draws`` swaps in one of the three JAX streams alone (``noise``: the
action noise; ``perm``: the update's permutation; ``resets``: the env's
reset draws) and leaves the other two to the port's own generators, seeded
as ``OnPolicyRunner`` seeds them for that seed (the algorithm's generator
from ``seed + 1``, the env's per-env keys from ``seed``); the initial
policy and env state stay the JAX runner's. ``all`` (the default) swaps in
all three.

``--init port`` starts from the port's own initial policy and env state
instead, seeded as ``OnPolicyRunner`` seeds them (the policy's generator
from ``seed``, the env's reset from ``seed``), with the JAX streams of
``--draws`` after it: the arm that tells a fault of the port's
initialisation or initial env draws from one of its streams.
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
#: the JAX streams ``--draws`` can swap in
STREAMS = ("noise", "perm", "resets")


def _t(x):
    return torch.tensor(np.asarray(x))


def stream_run(seed: int, iterations: int, max_episode_length: int = MAX_EPISODE_LENGTH, draws=STREAMS,
               init: str = "jax"):
    """The port's curve (one mean completed-episode reward an iteration, nan
    where none completed) and per-iteration metrics, with the JAX run's
    streams named in ``draws`` and the port's own for the others, from the
    JAX runner's initial policy and env state (``init="jax"``) or the port's
    own (``init="port"``), and the JAX runner whose streams it took."""
    jenv = JaxNLink(num_envs=NUM_ENVS, num_links=NUM_LINKS, max_episode_length=max_episode_length)
    jax_runner = JaxRunner(jenv, train_cfg(seed), log_dir=None)
    ts, cs = jax_runner.train_state, jax_runner.collect_state
    cfg = train_cfg(seed)
    policy_kw = {k: v for k, v in cfg["policy"].items() if k != "class_name"}
    alg_kw = {k: v for k, v in cfg["algorithm"].items() if k != "class_name"}
    env = NLinkPendulum(NUM_ENVS, NUM_LINKS, max_episode_length=max_episode_length, device="cpu")
    if init == "port":  # as OnPolicyRunner builds them for this seed
        env_state, obs = env.reset(seed)
        policy = ActorCritic(obs, cfg["obs_groups"], NUM_LINKS, device="cpu", seed=seed, **policy_kw)
    else:
        obs = {k: _t(v) for k, v in cs.obs.items()}
        policy = ActorCritic(obs, cfg["obs_groups"], NUM_LINKS, device="cpu", **policy_kw)
        ps = jax.device_get(ts.policy)
        norm = {k: None if v is None else {f: np.asarray(getattr(v, f)) for f in ("mean", "var", "count")}
                for k, v in ps.norm.items()}
        from_jax_state(ps.params, norm, policy)
        st = jax.device_get(cs.env_state)
        env_state = NLinkState(_t(st.episode_length), _t(st.theta), _t(st.omega), env_keys(seed, NUM_ENVS))
    ppo = PPO(policy, seed=seed + 1, **alg_kw)  # the runner's seed of the algorithm's generator
    fresh = []  # the JAX env's reset draws, one entry a step
    if "resets" in draws:
        env._sample_init = lambda rng: (rng, fresh.pop(0))
    port_cs = CollectState(env_state=env_state, obs=obs, carry=(), stats=init_episode_stats(NUM_ENVS, "cpu"))

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
        if "resets" not in draws:
            fresh.clear()
        action_noise = torch.tensor(np.stack(noise)) if "noise" in draws else None
        perm = _t(permutation(k_perm)) if "perm" in draws else None
        port_cs, rollout, cm = ppo.collect(env, port_cs, T, action_noise=action_noise)
        port_cs, um = ppo.update(port_cs, rollout, perm=perm)
        count = float(cm["ep_count"])
        curve.append(float(cm["ep_reward_sum"]) / count if count > 0 else float("nan"))
        history.append({k: float(v) for k, v in {**cm, **um}.items()})
    return curve, history, jax_runner


def final(curve) -> float:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(np.asarray(curve[-20:], np.float64)))


def summarize(paths, out_path, against: str = "parity_torch_results.json") -> dict:
    """Pool the ``--out`` files of one ``--draws`` setting (their seeds) and
    hold the finals against the 40 single-seed runs of ``parity_torch.py``'s
    ``b40_single`` study: the JAX runs and the port's own (Welch's t and
    Mann-Whitney U, two-sided); writes ``out_path``."""
    from scipy import stats

    runs = [json.load(open(p)) for p in paths]
    if len({(r["draws"], r.get("init", "jax"), r["iterations"]) for r in runs}) != 1:
        raise ValueError("the files mix --draws, --init or --iterations settings")
    seeds = {k: v for r in runs for k, v in r["seeds"].items()}
    finals = np.array([v["final"] for v in seeds.values()])
    ref = json.load(open(against))["studies"]["b40_single"]
    summary = {"script": "tests/torch_port_stream_parity.py", "draws": runs[0]["draws"],
               "init": runs[0].get("init", "jax"),
               "iterations": runs[0]["iterations"], "platform": "cpu", "num_seeds": len(seeds),
               "finals_mean": float(finals.mean()), "finals_std": float(finals.std(ddof=1)),
               "finals_median": float(np.median(finals))}
    for name, arm in (("against_jax_files", "jax"), ("against_port_b40_single", "port")):
        other = np.array(ref[arm]["per_seed"])
        summary[name] = {"welch_t_p": float(stats.ttest_ind(finals, other, equal_var=False).pvalue),
                         "mann_whitney_u_p": float(stats.mannwhitneyu(finals, other, alternative="two-sided").pvalue)}
    summary["seeds"] = seeds
    with open(out_path, "w") as f:
        json.dump(summary, f)
    return summary


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+")
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--out", default=None)
    p.add_argument("--draws", choices=("all",) + STREAMS, default="all",
                   help="the JAX stream to swap in alone (default: all three)")
    p.add_argument("--init", choices=("jax", "port"), default="jax",
                   help="start from the JAX runner's initial policy and env state or the port's own")
    p.add_argument("--summarize", nargs="+", metavar="FILE",
                   help="pool these --out files into --out, against parity_torch_results.json's b40_single")
    args = p.parse_args()
    if args.summarize:
        summary = summarize(args.summarize, args.out)
        print(json.dumps({k: v for k, v in summary.items() if k != "seeds"}))
        return
    draws = STREAMS if args.draws == "all" else (args.draws,)
    torch.set_num_threads(2)
    out = {}
    for seed in args.seeds:
        curve, _, _ = stream_run(seed, args.iterations, draws=draws, init=args.init)
        out[seed] = {"final": final(curve), "curve": [None if np.isnan(v) else v for v in curve]}
        print(json.dumps({"seed": seed, "final": out[seed]["final"]}), flush=True)
        if args.out:  # after every seed, so a cut run keeps what it finished
            with open(args.out, "w") as f:
                json.dump({"draws": args.draws, "init": args.init, "iterations": args.iterations, "seeds": out}, f)


if __name__ == "__main__":
    main()
