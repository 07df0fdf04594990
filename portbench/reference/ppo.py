"""Plain PPO of the benchmark's configurations: the reference that decides
whether the port's timed path trains correctly.

Plain PyTorch from the published description of RSL-RL's PPO (clipped
surrogate and value losses, entropy bonus, GAE with whitened advantages,
adaptive-KL learning rate, global-norm clip, Adam) with its
``ActorCritic`` / ``ActorCriticRecurrent`` policies (ELU MLP trunks, a
single-layer memory in front of each, running observation normalization, a
scalar Gaussian std), on :class:`~portbench.reference.nlink.NLink`. The
memory's arithmetic is its family's file, ``cells/<rnn_type>.py``
(``harness.load_memory``): ``layout``, ``zeros``, ``step`` and ``output``;
here a carry is that file's tree of tensors, mapped leaf by leaf.
It imports nothing of the port. Where the configuration states bf16 trunks,
a hidden layer computes as flax ``nn.Dense(dtype=bfloat16)`` does (operands
and bias in bf16, the activation in bf16) and the heads in fp32.

Both sides are handed the same inputs: the initial weights (:func:`make_weights`,
from the seed, on the device) and the random draws, which come from one
Philox generator seeded with ``seed + 1`` in a fixed order: the action noise
of every step (``randn [N, A]``), then for a feedforward update one
permutation of the window's rows. ``operand`` is the control's lower
precision: ``"fp8"`` rounds every trunk operand to float8 e4m3 before its
bf16 product; TF32 is switched by the caller through torch's flags.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.nlink import NLink

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
NORM_EPS = 1e-2
#: derived from the cell's seed, so the weights' draws are not the noise's
WEIGHT_SEED_SALT = 0x5745494748


def param_layout(cfg: dict, obs_dim: int, num_actions: int, memory=None) -> list[tuple[str, tuple, float | None]]:
    """``(name, shape, bound)`` of every trained parameter, in the order the
    optimizer sums them: the std (``bound`` None: ones), the actor's and the
    critic's layers, then the two memories (``U(-bound, bound)``: a linear
    layer's ``1/sqrt(fan_in)``, a memory's leaves as ``memory.layout``
    gives them)."""
    pol = cfg["policy"]
    H = _hidden(pol, memory)
    out = [("std", (num_actions,), None)]
    for net, dims, final in (("actor", pol["actor_hidden_dims"], num_actions), ("critic", pol["critic_hidden_dims"], 1)):
        sizes = [H or obs_dim, *dims, final]
        for i in range(len(sizes) - 1):
            b = 1.0 / math.sqrt(sizes[i])
            out += [(f"{net}.dense_{i}.weight", (sizes[i + 1], sizes[i]), b), (f"{net}.dense_{i}.bias", (sizes[i + 1],), b)]
    if H:
        for mem in ("memory_a", "memory_c"):
            out += [(f"{mem}.cell_0.{leaf}", shape, b) for leaf, shape, b in memory.layout(obs_dim, H)]
    return out


def _hidden(pol: dict, memory) -> int | None:
    """The memory's width of a recurrent policy (the port's default 256), None for a feedforward one."""
    if pol["class_name"] != "ActorCriticRecurrent":
        return None
    if memory is None:
        raise ValueError("a recurrent policy needs its memory family (harness.load_memory)")
    return pol.get("rnn_hidden_dim", 256)


def make_weights(layout, seed: int, device) -> dict[str, torch.Tensor]:
    """The initial weights of a cell from its seed: one uniform draw on the
    device for all of them, cut and scaled per parameter (fp32)."""
    gen = torch.Generator(device=device).manual_seed((int(seed) ^ WEIGHT_SEED_SALT) % 2**63)
    sizes = [math.prod(shape) for _, shape, _ in layout]
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, bound), n in zip(layout, sizes):
        part = flat[off:off + n].view(shape)
        out[name] = torch.ones(shape, device=device) if bound is None else (part * 2.0 - 1.0) * bound
        off += n
    return out


def dtype_of(name: str | None):
    """A configuration's ``dtype``: None for fp32, else the torch dtype."""
    return None if name in (None, "float32") else getattr(torch, name)


class ReferencePPO:
    """One PPO run of ``cfg`` (the configuration file's ``train_cfg`` and
    ``env``) on ``num_envs`` envs from ``weights``; :meth:`iteration` runs a
    window and an update and returns the update's mean losses. ``memory``
    is the memory family's module of a recurrent policy."""

    def __init__(self, cfg: dict, env_cfg: dict, num_envs: int, weights: dict, seed: int, device, memory=None,
                 random_episode_lengths: bool = False, operand: str | None = None, half_batch: bool = False,
                 parts: int = 1):
        self.alg, self.pol = cfg["algorithm"], cfg["policy"]
        H = _hidden(self.pol, memory)
        self.recurrent, self.memory = H is not None, memory
        self.dtype = dtype_of(self.pol.get("dtype"))
        fp8 = operand == "fp8"
        self.op = (lambda t: t.to(torch.float8_e4m3fn).to(t.dtype)) if fp8 else (lambda t: t)
        #: a planted fault: each minibatch's loss over its first half only
        self.half_batch = half_batch
        #: the witness of a mesh's reordered sums: each minibatch's gradient
        #: as ``parts`` data ranks compute it (:meth:`_grads`)
        self.parts = parts
        self.env = NLink(num_envs, env_cfg["num_links"], env_cfg["max_episode_length"], device)
        self.env_state, self.obs = self.env.reset(seed)
        if random_episode_lengths:
            self.env_state = self.env.randomize_episode_length(self.env_state)
        self.T = cfg["num_steps_per_env"]
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
        self.names = list(weights)
        self.mu = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.count = torch.zeros((), device=device)
        self.lr = torch.tensor(float(self.alg["learning_rate"]), device=device)
        D = self.obs.shape[-1]
        self.norms = {k: [torch.zeros(D, device=device), torch.ones(D, device=device), torch.zeros((), device=device)]
                      for k in ("actor", "critic")}
        self.carry = {k: memory.zeros(num_envs, H, device) for k in ("actor", "critic")} if self.recurrent else None
        self.gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        self.device = device

    # ----------------------------------------------------------------- state

    def snapshot(self) -> dict:
        """The training state between iterations (copies): parameters, Adam's
        moments and count, the learning rate, the normalizers' moments, the
        env state, the current obs and the memories' carry."""
        return clone_tree({"params": self.params, "mu": self.mu, "nu": self.nu, "count": self.count, "lr": self.lr,
                       "norms": self.norms, "env": self.env_state, "obs": self.obs, "carry": self.carry})

    def load_state(self, snap: dict) -> None:
        """Continue from ``snap`` (the form of :meth:`snapshot`); the
        generator keeps its own stream."""
        snap = clone_tree(snap)
        self.params = {k: v.float().requires_grad_(True) for k, v in snap["params"].items()}
        self.mu, self.nu = snap["mu"], snap["nu"]
        self.count, self.lr = snap["count"].float(), snap["lr"].float()
        self.norms = {k: list(v) for k, v in snap["norms"].items()}
        self.env_state, self.obs, self.carry = snap["env"], snap["obs"], snap["carry"]

    # ---------------------------------------------------------------- policy

    def _norm(self, which, x):
        mean, var, _ = self.norms[which]
        return (x - mean) / (torch.sqrt(var) + NORM_EPS)

    @torch.no_grad()
    def _update_norms(self, x):
        for which in ("actor", "critic"):
            mean, var, count = self.norms[which]
            n = x.shape[0]
            mean_x, var_x = x.mean(0), x.var(0, unbiased=False)
            new_count = count + n
            rate = n / new_count
            delta = mean_x - mean
            new_mean = mean + rate * delta
            self.norms[which] = [new_mean, var + rate * (var_x - var + delta * (mean_x - new_mean)), new_count]

    def _mlp(self, net, x):
        P, n = self.params, len(self.pol[f"{net}_hidden_dims"]) + 1
        for i in range(n):
            w, b = P[f"{net}.dense_{i}.weight"], P[f"{net}.dense_{i}.bias"]
            head = i == n - 1
            if self.dtype is None:
                x = F.linear(x, w, b)
            elif head:
                x = torch.matmul(x.to(torch.float32), w.T) + b
            else:
                dt = self.dtype
                x = torch.matmul(self.op(x.to(dt)), self.op(w.to(dt)).T) + b.to(dt)
            if not head:
                x = F.elu(x)
        return x.to(torch.float32)

    def _memory_step(self, mem, carry, x):
        prefix = f"{mem}.cell_0."
        P = {k.removeprefix(prefix): v for k, v in self.params.items() if k.startswith(prefix)}
        return self.memory.step(P, carry, x, self.dtype, self.op)

    def _replay(self, mem, carry, xs, resets):
        outs = []
        for t in range(xs.shape[0]):
            keep = (1.0 - resets[t])[:, None]
            carry = self._memory_step(mem, map_carry(lambda v: v * keep, carry), xs[t])
            outs.append(self.memory.output(carry))
        return torch.stack(outs)

    # ------------------------------------------------------------- iteration

    @torch.no_grad()
    def _collect(self):
        steps = {k: [] for k in ("obs", "actions", "rewards", "dones", "values", "log_probs", "mu", "sigma")}
        carry0 = self.carry
        obs, carry, gamma = self.obs, self.carry, self.alg["gamma"]
        for _ in range(self.T):
            fa, fc = self._norm("actor", obs), self._norm("critic", obs)
            if self.recurrent:
                carry = {**carry, "actor": self._memory_step("memory_a", carry["actor"], fa)}
                fa = self.memory.output(carry["actor"])
            mean = self._mlp("actor", fa)
            std = self.params["std"].expand_as(mean)
            noise = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device, generator=self.gen)
            action = mean + std * noise
            log_p = _log_prob(mean, std, action)
            if self.recurrent:
                carry = {**carry, "critic": self._memory_step("memory_c", carry["critic"], fc)}
                fc = self.memory.output(carry["critic"])
            value = self._mlp("critic", fc).squeeze(-1)
            self.env_state, next_obs, rew, done = self.env.step(self.env_state, action)
            self._update_norms(next_obs)
            total = rew + gamma * value * done.to(torch.float32)
            if self.recurrent:
                keep = (1.0 - done.to(torch.float32))[:, None]
                carry = {k: map_carry(lambda v: v * keep, c) for k, c in carry.items()}
            for k, v in (("obs", obs), ("actions", action), ("rewards", total), ("dones", done), ("values", value),
                         ("log_probs", log_p), ("mu", mean), ("sigma", std)):
                steps[k].append(v)
            obs = next_obs
        self.obs, self.carry = obs, carry
        return {k: torch.stack(v) for k, v in steps.items()}, carry0

    @torch.no_grad()
    def _gae(self, roll):
        fc = self._norm("critic", self.obs)
        if self.recurrent:
            self.carry = {**self.carry, "critic": self._memory_step("memory_c", self.carry["critic"], fc)}
            fc = self.memory.output(self.carry["critic"])
        next_values = self._mlp("critic", fc).squeeze(-1)
        gamma, lam = self.alg["gamma"], self.alg["lam"]
        values, not_term = roll["values"], 1.0 - roll["dones"].to(torch.float32)
        adv = torch.zeros_like(next_values)
        advantages = torch.empty_like(values)
        for t in reversed(range(values.shape[0])):
            delta = roll["rewards"][t] + not_term[t] * gamma * next_values - values[t]
            adv = delta + not_term[t] * (gamma * lam) * adv
            advantages[t] = adv
            next_values = values[t]
        returns = advantages + values
        return returns, (advantages - advantages.mean()) / (advantages.std(unbiased=True) + 1e-8)

    def _minibatches(self, roll, returns, adv, carry0):
        """``(batch, carry0)`` of every minibatch of every epoch, in order."""
        E, M = self.alg["num_learning_epochs"], self.alg["num_mini_batches"]
        fields = {**roll, "returns": returns, "advantages": adv}
        if self.recurrent:
            fields["resets"] = torch.cat([torch.zeros_like(roll["dones"][:1]), roll["dones"][:-1]]).to(torch.float32)
            nb = roll["dones"].shape[1] // M
            for _ in range(E):
                for i in range(M):
                    yield ({k: v[:, i * nb:(i + 1) * nb] for k, v in fields.items()},
                           {k: map_carry(lambda v: v[i * nb:(i + 1) * nb], c) for k, c in carry0.items()})
            return
        n = roll["dones"].numel()
        perm = torch.randperm(M * (n // M), generator=self.gen, device=self.device)
        rows = {k: v.reshape(n, *v.shape[2:])[perm] for k, v in fields.items() if k not in ("rewards", "dones")}
        mb = perm.numel() // M
        for _ in range(E):
            for i in range(M):
                yield {k: v[i * mb:(i + 1) * mb] for k, v in rows.items()}, None

    def _loss(self, b, carry0):
        if self.half_batch:
            axis = 1 if self.recurrent else 0
            b = {k: v.narrow(axis, 0, v.shape[axis] // 2) for k, v in b.items()}
            carry0 = None if carry0 is None else {k: map_carry(lambda v: v[: v.shape[0] // 2], c)
                                                  for k, c in carry0.items()}
        fa, fc = self._norm("actor", b["obs"]), self._norm("critic", b["obs"])
        if self.recurrent:
            fa = self._replay("memory_a", carry0["actor"], fa, b["resets"])
            fc = self._replay("memory_c", carry0["critic"], fc, b["resets"])
        mean = self._mlp("actor", fa)
        std = self.params["std"].expand_as(mean)
        value = self._mlp("critic", fc).squeeze(-1)
        clip = self.alg["clip_param"]
        logp = _log_prob(mean, std, b["actions"])
        entropy = torch.sum(0.5 + LOG_SQRT_2PI + torch.log(std), dim=-1).mean()
        kl = torch.sum(torch.log(std.detach() / b["sigma"] + 1e-5)
                       + (torch.square(b["sigma"]) + torch.square(b["mu"] - mean.detach()))
                       / (2.0 * torch.square(std.detach())) - 0.5, dim=-1).mean()
        ratio = torch.exp(logp - b["log_probs"])
        surrogate = torch.maximum(-b["advantages"] * ratio,
                                  -b["advantages"] * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)).mean()
        v_clipped = b["values"] + torch.clamp(value - b["values"], -clip, clip)
        value_loss = torch.maximum(torch.square(value - b["returns"]), torch.square(v_clipped - b["returns"])).mean()
        loss = surrogate + self.alg["value_loss_coef"] * value_loss - self.alg["entropy_coef"] * entropy
        return loss, {"value_function": value_loss, "surrogate": surrogate, "entropy": entropy, "kl": kl}

    def _grads(self, batch, carry0):
        """The minibatch's gradients and losses. With ``parts`` > 1 as that
        many data ranks compute a feedforward minibatch: each its contiguous
        share of the rows, its loss means scaled to the minibatch's count,
        the shares' gradients and losses summed in rank order."""
        params = [self.params[n] for n in self.names]
        if self.parts == 1:
            loss, aux = self._loss(batch, carry0)
            return torch.autograd.grad(loss, params), aux
        if self.recurrent:
            raise ValueError("the mesh's witness follows the feedforward layout")
        n = batch["actions"].shape[0]
        share = -(-n // self.parts)
        grads, aux = None, {}
        for lo in range(0, n, share):
            k = min(share, n - lo)
            loss, part_aux = self._loss({key: v.narrow(0, lo, k) for key, v in batch.items()}, None)
            g = torch.autograd.grad(loss * (k / n), params)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            for key, v in part_aux.items():
                aux[key] = aux.get(key, 0.0) + v * (k / n)
        return grads, aux

    def _step(self, grads, kl):
        a = self.alg
        with torch.no_grad():
            up = torch.clamp(self.lr * 1.5, max=a["max_lr"])
            down = torch.clamp(self.lr / 1.5, min=a["min_lr"])
            dkl = a["desired_kl"]
            self.lr = torch.where(kl > dkl * 2.0, down, torch.where((kl < dkl / 2.0) & (kl > 0.0), up, self.lr))
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < a["max_grad_norm"]
            grads = [torch.where(keep, g, (g / norm) * a["max_grad_norm"]) for g in grads]
            self.count = self.count + 1.0
            bc1 = 1.0 - torch.pow(torch.full_like(self.count, B1), self.count)
            bc2 = 1.0 - torch.pow(torch.full_like(self.count, B2), self.count)
            for name, g in zip(self.names, grads):
                self.mu[name] = (1.0 - B1) * g + B1 * self.mu[name]
                self.nu[name] = (1.0 - B2) * (g * g) + B2 * self.nu[name]
                u = (self.mu[name] / bc1) / (torch.sqrt(self.nu[name] / bc2) + ADAM_EPS)
                self.params[name].sub_(self.lr * u)

    def iteration(self) -> dict[str, float]:
        """One window and one update; the update's losses averaged over its minibatches."""
        roll, carry0 = self._collect()
        returns, adv = self._gae(roll)
        sums: dict[str, list] = {}
        for batch, c0 in self._minibatches(roll, returns, adv, carry0):
            grads, aux = self._grads(batch, c0)
            self._step(grads, aux["kl"].detach())
            for k, v in aux.items():
                sums.setdefault(k, []).append(v.detach())
        return {**{k: float(torch.stack(v).mean()) for k, v in sums.items()}, "learning_rate": float(self.lr)}


def map_carry(f, carry):
    """``f`` of every tensor of a memory's carry: a tensor, or a tuple of carries."""
    if isinstance(carry, tuple):
        return tuple(map_carry(f, c) for c in carry)
    return f(carry)


def clone_tree(tree):
    """Copies of the tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


def _log_prob(mean, std, x):
    z = (x - mean) / std
    return torch.sum(-0.5 * torch.square(z) - torch.log(std) - LOG_SQRT_2PI, dim=-1)
