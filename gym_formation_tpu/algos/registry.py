"""Algorithm registry: one factory for all 13 CLI algorithms and a universal
checkpoint-eval surface.

The reference keeps one eval/render driver per trainer generation
(``train/maddpg-v2/evaluate.py:14-81``, ``train/maddpg-v5/render.py:136-137``,
``train/mappo/inbox/render_formation.py:60-129``); here a single registry maps
an algorithm name to (constructor, config class, checkpoint layout, greedy
eval policy), so ``train.py`` and ``eval.py`` share one factory and any
algorithm's checkpoint can be evaluated/rendered/GIF'd — including the
recurrent families, whose GRU carries are threaded through the eval loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jnp.ndarray

#: every name accepted by ``train.py --algo`` (the reference v1/v2/v5/mappo
#: trainer surface, ``train/maddpg-v5/train.py:41-56``)
ALGO_NAMES = (
    "mappo", "rmappo", "maddpg", "ddpg", "matd3", "masac",
    "qmix", "vdn", "rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn",
)

#: algorithms whose env actions are 5-way one-hots by construction
DISCRETE_ONLY = ("qmix", "vdn", "rqmix", "rvdn")
#: recurrent (GRU) actor families — eval threads a hidden carry
RECURRENT = ("rmappo", "rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")
#: on-policy family: train tuple (ts, env_state, obs[, carry])
ONPOLICY = ("mappo", "rmappo")
#: episodic recurrent off-policy: train tuple (ts, buffer)
EPISODIC = ("rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn")


def make_algo(
    name: str,
    env,
    num_envs: int,
    sets: Sequence[str] = (),
    config_yaml: Optional[str] = None,
    lr: Optional[float] = None,
):
    """Build the algorithm object for ``name`` over ``env``.

    ``sets`` are ``key=value`` config overrides (applied last), ``config_yaml``
    an optional YAML override file (the v4 ``parameters.yaml`` path), ``lr`` a
    convenience learning-rate override mapped to the right field name(s).
    """
    from ..utils.config import load_config
    from .. import algos as A  # attribute access imports one learner

    if name not in ALGO_NAMES:
        raise ValueError(f"unknown algorithm {name!r}; choose from {ALGO_NAMES}")
    lr1 = [f"lr={lr}"] if lr is not None else []
    lr2 = [f"lr_actor={lr}", f"lr_critic={lr}"] if lr is not None else []
    sets = list(sets)

    def cfg_of(cls, base, extra=()):
        # defaults <- yaml <- implied flags <- explicit --set overrides
        return load_config(cls, config_yaml, [*base, *extra, *sets])

    if name == "mappo":
        return A.MAPPO(env, cfg_of(A.MAPPOConfig, lr1), num_envs=num_envs)
    if name == "rmappo":
        return A.RMAPPO(env, cfg_of(A.RMAPPOConfig, lr1), num_envs=num_envs)
    if name in ("maddpg", "ddpg"):
        return A.MADDPG(
            env,
            cfg_of(A.MADDPGConfig, lr2, [f"centralized={name == 'maddpg'}"]),
            num_envs=num_envs,
        )
    if name == "matd3":
        return A.MATD3(env, cfg_of(A.MATD3Config, lr2), num_envs=num_envs)
    if name == "masac":
        return A.MASAC(env, cfg_of(A.MASACConfig, lr1), num_envs=num_envs)
    if name in ("rmaddpg", "rmatd3"):
        return A.RMADDPG(
            env,
            cfg_of(A.RMADDPGConfig, lr2, [f"twin={name == 'rmatd3'}"]),
            num_envs=num_envs,
        )
    if name == "rmasac":
        return A.RMASAC(env, cfg_of(A.RMASACConfig, lr1), num_envs=num_envs)
    if name in ("rqmix", "rvdn"):
        return A.RQMix(
            env, cfg_of(A.RQMixConfig, [], [f"mixer={name[1:]}", *lr1]),
            num_envs=num_envs,
        )
    # qmix / vdn (MLP variants)
    return A.QMix(
        env, cfg_of(A.QMixConfig, [], [f"mixer={name}", *lr1]), num_envs=num_envs
    )


def eval_policy(
    name: str,
    algo,
    ts_raw: dict,
    batch_size: int,
    clip_continuous: bool = True,
    stochastic: bool = False,
) -> Tuple[Callable, Optional[tuple]]:
    """Greedy eval policy from a raw-restored training state.

    ``stochastic=True`` (mappo only) samples the policy distribution
    instead of taking its mode — the honest evaluation of a stochastic
    controller whose behavior policy is the thing that earns the training
    reward (e.g. the N=243 saturated-σ regime, RESULTS.md r5); the carry
    threads the PRNG key.

    ``ts_raw`` is element 0 of the checkpointed training tuple as returned by
    :func:`~gym_formation_tpu.utils.restore_raw` (plain dicts keyed by the
    state dataclass field names — only the actor/Q params are consumed, so the
    checkpoint's env-batch and buffer shapes don't matter).

    Returns ``(policy_fn, carry0)`` with ``policy_fn(obs, carry) ->
    (actions, carry)`` over an ``[batch, N, obs_dim]`` observation batch.
    MLP families have ``carry0 = None`` and ignore/return ``carry``
    unchanged; recurrent families thread ``(hidden, reset_flags)`` — call
    with ``carry0`` at each episode start (its reset flags zero the GRU
    state on the first step, matching training-time episode boundaries).
    """
    B = batch_size
    high = getattr(algo.cfg, "high_action", 1.0)

    def _clip(a):
        # clip to the control range like the reference agents
        # (maddpg-v1/agent.py:22); unbounded policy means explode through
        # the hierarchical tar_vel feedback when BFS-expanded
        return jnp.clip(a, -high, high) if clip_continuous else a

    if name == "mappo":
        params = ts_raw["params"]

        if stochastic:

            def policy(obs, carry):
                carry, k = jax.random.split(carry)
                a = algo._dist_sample(k, algo._apply_actor(params["actor"], obs))
                return (a if algo.discrete else _clip(a)), carry

            return policy, jax.random.PRNGKey(1234)

        def policy(obs, carry=None):
            a = algo._dist_mode(algo._apply_actor(params["actor"], obs))
            return (a if algo.discrete else _clip(a)), carry

        return policy, None
    if stochastic:
        raise SystemExit("--stochastic eval is implemented for mappo only")

    if name == "rmappo":
        params = ts_raw["params"]
        carry0 = (
            jnp.zeros((B, algo.n_agents, algo.cfg.gru_hidden)),
            jnp.ones((B,), bool),
        )

        def policy(obs, carry):
            h, reset = carry
            reset_n = jnp.broadcast_to(reset[:, None], obs.shape[:2])
            h, dist = algo.actor.apply(params["actor"], h, obs, reset_n)
            a = algo._dist_mode(dist)
            return (a if algo.discrete else _clip(a)), (h, jnp.zeros_like(reset))

        return policy, carry0

    if name in ("maddpg", "ddpg", "matd3"):
        from ..models.networks import onehot_from_logits

        actor_params = ts_raw["actor_params"]

        def policy(obs, carry=None):
            out = algo._actor_all(actor_params, obs)
            return (onehot_from_logits(out) if algo.discrete else _clip(out)), carry

        return policy, None

    if name == "masac":
        from ..models.networks import onehot_from_logits

        actor_params = ts_raw["actor_params"]

        def policy(obs, carry=None):
            dist = algo._actor_all(actor_params, obs)
            if algo.discrete:
                return onehot_from_logits(dist), carry
            return jnp.tanh(dist[0]) * high, carry

        return policy, None

    if name in ("qmix", "vdn"):
        q_params = ts_raw["q_params"]

        def policy(obs, carry=None):
            q = algo._q_all(q_params, obs)
            return (
                jax.nn.one_hot(jnp.argmax(q, -1), algo.N_ACTIONS, dtype=obs.dtype),
                carry,
            )

        return policy, None

    if name in ("rmaddpg", "rmatd3"):
        actor_params = ts_raw["actor_params"]
        carry0 = (
            jnp.zeros((B, algo.n_agents, algo.cfg.gru_hidden)),
            jnp.ones((B,), bool),
        )

        def policy(obs, carry):
            h, reset = carry
            # _actor_step already tanh-bounds to ±high_action
            h, a = algo._actor_step(actor_params, h, obs, reset)
            return a, (h, jnp.zeros_like(reset))

        return policy, carry0

    if name == "rmasac":
        actor_params = ts_raw["actor_params"]
        carry0 = (
            jnp.zeros((B, algo.n_agents, algo.cfg.gru_hidden)),
            jnp.ones((B,), bool),
        )

        def policy(obs, carry):
            h, reset = carry
            h, (mean, _) = algo._actor_step(actor_params, h, obs, reset)
            return jnp.tanh(mean) * high, (h, jnp.zeros_like(reset))

        return policy, carry0

    if name in ("rqmix", "rvdn"):
        q_params = ts_raw["q_params"]
        carry0 = (
            jnp.zeros((B, algo.n_agents, algo.cfg.gru_hidden)),
            jnp.ones((B,), bool),
        )

        def policy(obs, carry):
            h, reset = carry
            h, q = algo._q_step(q_params, h, obs, reset)
            a = jax.nn.one_hot(jnp.argmax(q, -1), algo.N_ACTIONS, dtype=obs.dtype)
            return a, (h, jnp.zeros_like(reset))

        return policy, carry0

    raise ValueError(f"unknown algorithm {name!r}; choose from {ALGO_NAMES}")
