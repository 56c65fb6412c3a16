"""Networks for the MAPPO learners, in plain JAX.

Scale mirrors the reference baselines: 64-hidden ReLU MLPs with orthogonal
init (``train/maddpg-v1/maddpg/actor_critic.py:7-43``;
``train/maddpg-v2/utils/networks.py:4-46``; mappo's shared 64-hidden nets per
``train/mappo/train_formation.sh:13`` defaults).  Each network has the
``init(key, x) -> params`` / ``apply(params, x)`` surface, and its parameter
tree is laid out as a ``flax.linen`` module of the same structure would lay
it out (``{"params": {"MLP_0": {"Dense_0": {"kernel", "bias"}, ...},
"Dense_0": ..., "log_std"}}``), so checkpoints and the factorized layers of
:mod:`.structured_obs` read it by name.  Everything is batch-first and
jit/vmap friendly.  The off-policy and recurrent learners' networks are
``flax.linen`` modules in :mod:`.flax_networks`.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def orthogonal_init(scale: float = 2.0 ** 0.5):
    return jax.nn.initializers.orthogonal(scale)


def soft_bound(x: Array, lo: float, hi: float) -> Array:
    """Smoothly bound ``x`` to (lo, hi) with nonzero gradient everywhere
    (a hard clip freezes the parameter permanently once it crosses a bound:
    the clipped branch has zero gradient).  Identity-like near 0."""
    return hi - jax.nn.softplus(hi - (lo + jax.nn.softplus(x - lo)))


def _dense_init(key, fan_in: int, fan_out: int, scale: float) -> dict:
    return {
        "kernel": orthogonal_init(scale)(key, (fan_in, fan_out), jnp.float32),
        "bias": jnp.zeros((fan_out,), jnp.float32),
    }


def _dense(p: dict, x: Array) -> Array:
    return x @ p["kernel"] + p["bias"]


class MLP:
    """ReLU MLP trunk with orthogonal init (reference mappo/maddpg-v4 style,
    ``maddpg-v4/parameters.yaml``).  Parameters ``{"Dense_i": ...}``."""

    def __init__(self, features: Sequence[int], activation: Callable = jax.nn.relu):
        self.features = tuple(features)
        self.activation = activation

    def init_params(self, key, fan_in: int) -> dict:
        keys = jax.random.split(key, len(self.features))
        params = {}
        for i, (k, f) in enumerate(zip(keys, self.features)):
            params[f"Dense_{i}"] = _dense_init(k, fan_in, f, 2.0 ** 0.5)
            fan_in = f
        return params

    def __call__(self, params: dict, x: Array) -> Array:
        for i in range(len(self.features)):
            x = self.activation(_dense(params[f"Dense_{i}"], x))
        return x


class _MLPHead:
    """MLP trunk then one orthogonal-init dense head; the base of the three
    networks below."""

    head_scale = 1.0

    def __init__(self, out_dim: int, hidden: Sequence[int]):
        self.out_dim = out_dim
        self.hidden = tuple(hidden)
        self.trunk = MLP(self.hidden)

    def _init(self, key, x: Array) -> dict:
        k_trunk, k_head = jax.random.split(key)
        fan_in = self.hidden[-1] if self.hidden else x.shape[-1]
        return {
            "MLP_0": self.trunk.init_params(k_trunk, x.shape[-1]),
            "Dense_0": _dense_init(k_head, fan_in, self.out_dim, self.head_scale),
        }

    def init(self, key, x: Array) -> dict:
        return {"params": self._init(key, x)}

    def _head(self, params: dict, x: Array) -> Array:
        p = params["params"]
        return _dense(p["Dense_0"], self.trunk(p["MLP_0"], x))


class GaussianActor(_MLPHead):
    """Continuous stochastic policy for PPO/MAPPO: diagonal Gaussian with a
    state-independent learned log-std."""

    head_scale = 0.01

    def __init__(self, act_dim: int, hidden: Sequence[int] = (64, 64),
                 log_std_init: float = 0.0):
        super().__init__(act_dim, hidden)
        self.act_dim = act_dim
        self.log_std_init = log_std_init

    def init(self, key, obs: Array) -> dict:
        params = self._init(key, obs)
        params["log_std"] = jnp.full((self.act_dim,), self.log_std_init, jnp.float32)
        return {"params": params}

    def apply(self, params: dict, obs: Array) -> Tuple[Array, Array]:
        mean = self._head(params, obs)
        # guard rail: unbounded log_std drift eventually NaNs the PPO ratio
        log_std = soft_bound(params["params"]["log_std"], -5.0, 2.0)
        return mean, jnp.broadcast_to(log_std, mean.shape)


class ValueCritic(_MLPHead):
    """Centralized value head: share_obs (all agents' obs concatenated,
    ``environment.py:95-96``) → scalar value."""

    def __init__(self, hidden: Sequence[int] = (64, 64)):
        super().__init__(1, hidden)

    def apply(self, params: dict, share_obs: Array) -> Array:
        return self._head(params, share_obs).squeeze(-1)


class LogitsActor(_MLPHead):
    """Discrete-action actor: MLP → per-action logits (the reference v2
    discrete path, where the policy net's raw output feeds
    ``onehot_from_logits``/``gumbel_softmax`` —
    ``maddpg-v2/utils/agents.py:48-62``, ``utils/misc.py:49-80``)."""

    head_scale = 0.01

    def __init__(self, n_actions: int, hidden: Sequence[int] = (64, 64, 64)):
        super().__init__(n_actions, hidden)
        self.n_actions = n_actions

    def apply(self, params: dict, obs: Array) -> Array:
        return self._head(params, obs)


def onehot_from_logits(logits: Array) -> Array:
    """Greedy one-hot over the last axis (``maddpg-v2/utils/misc.py:49-57``;
    the ε-random branch lives in the caller's exploration logic)."""
    return jax.nn.one_hot(jnp.argmax(logits, axis=-1), logits.shape[-1], dtype=logits.dtype)


def gumbel_softmax_st(key, logits: Array, tau: float = 1.0) -> Array:
    """Straight-through Gumbel-softmax sample: hard one-hot forward, softmax
    gradient backward (``maddpg-v2/utils/misc.py:60-80``, hard=True path used
    by the discrete actor loss ``algorithms/maddpg.py:174``)."""
    g = jax.random.gumbel(key, logits.shape, logits.dtype)
    y = jax.nn.softmax((logits + g) / tau, axis=-1)
    y_hard = jax.nn.one_hot(jnp.argmax(y, axis=-1), logits.shape[-1], dtype=y.dtype)
    return y_hard + y - jax.lax.stop_gradient(y)


def categorical_logp(logits: Array, action_onehot: Array) -> Array:
    """log π(a|s) for a one-hot action over the last axis (the discrete
    branch of onpolicy's ACTLayer, mirrored by ``maddpg-v4/utils.py``'s
    multidiscrete heads — reference ``train/maddpg-v4/utils.py:118-160``)."""
    return jnp.sum(jax.nn.log_softmax(logits) * action_onehot, axis=-1)


def categorical_entropy(logits: Array) -> Array:
    logp = jax.nn.log_softmax(logits)
    return -jnp.sum(jnp.exp(logp) * logp, axis=-1)


def categorical_sample(key, logits: Array) -> Array:
    """One-hot sample over the last axis."""
    idx = jax.random.categorical(key, logits)
    return jax.nn.one_hot(idx, logits.shape[-1], dtype=logits.dtype)


def gaussian_logp(mean: Array, log_std: Array, action: Array) -> Array:
    """Diagonal-Gaussian log density, summed over action dims."""
    var = jnp.exp(2 * log_std)
    return jnp.sum(
        -0.5 * ((action - mean) ** 2 / var) - log_std - 0.5 * jnp.log(2 * jnp.pi),
        axis=-1,
    )


def gaussian_entropy(log_std: Array) -> Array:
    return jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e), axis=-1)


def gaussian_sample(key, mean: Array, log_std: Array) -> Array:
    return mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape, mean.dtype)
