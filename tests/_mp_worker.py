"""Worker process for the multi-process training test.

Launched by ``tests/test_sharding.py::test_multiprocess_train_step`` as 2 OS
processes federating over a localhost coordinator (CPU backend, 4 virtual
devices each → one 8-device global mesh), and once more as a single
8-device process for the reference metrics.  Each process:

1. :func:`initialize_multihost` — wires ``jax.distributed``;
2. :func:`pod_mesh` — one mesh over every device of the "pod";
3. generates its :func:`per_host_batch` slice of the env batch and assembles
   global arrays with :func:`host_local_to_global` / :func:`replicate_global`;
4. runs jitted MAPPO train_steps — XLA inserts the cross-process gradient
   collectives (the counterpart of the reference's gloo
   all-reduce helper, ``train/maddpg-v2/utils/misc.py:33-46``).

Usage: python _mp_worker.py <pid> <nproc> <coordinator> <metrics-out.json>
(env must force the CPU backend and the per-process virtual device count).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    pid, nproc, coord, outfile = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )

    import jax

    from gym_formation_tpu.parallel import (
        host_local_to_global,
        initialize_multihost,
        per_host_batch,
        pod_mesh,
        replicate_global,
    )

    initialize_multihost(coord, num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()

    import numpy as np

    import gym_formation_tpu as ft
    from gym_formation_tpu.algos import MAPPO, MAPPOConfig

    mesh = pod_mesh(tp=1)
    GLOBAL_ENVS = 16
    b_local = per_host_batch(GLOBAL_ENVS)

    env = ft.make_env("formation_hd_env", num_agents=3)
    algo = MAPPO(
        env, MAPPOConfig(rollout_len=4, ppo_epochs=2), num_envs=GLOBAL_ENVS
    )

    # Every process runs the same init from the same seed (host-local, on its
    # default device), then keeps only its slice of the env batch — the
    # pattern a real pod uses, where each host cannot hold the global batch.
    ts, env_state, obs = algo.init(jax.random.PRNGKey(0))
    lo, hi = pid * b_local, (pid + 1) * b_local
    local = jax.tree.map(
        lambda x: np.asarray(x)[lo:hi] if np.ndim(x) >= 1 else x,
        (env_state, obs),
    )
    env_state, obs = host_local_to_global(local, mesh)
    ts = replicate_global(jax.device_get(ts), mesh)

    for i in range(2):
        ts, env_state, obs, metrics = algo.train_step(
            ts, env_state, obs, jax.random.PRNGKey(1 + i)
        )
    metrics = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in metrics.values()), metrics

    if pid == 0:
        with open(outfile, "w") as f:
            json.dump(metrics, f)
    print(f"worker {pid}/{nproc} ok", flush=True)


if __name__ == "__main__":
    main()
