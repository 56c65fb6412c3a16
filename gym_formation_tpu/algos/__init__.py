"""The learners.  Each is imported on first use, so that importing one (for
example ``gym_formation_tpu.algos.mappo``) loads neither the others nor
``flax``, which only the off-policy and recurrent learners need."""

import importlib

_WHERE = {
    "MAPPO": "mappo",
    "MAPPOConfig": "mappo",
    "MAPPOState": "mappo",
    "ValueNorm": "mappo",
    "MADDPG": "maddpg",
    "MADDPGConfig": "maddpg",
    "MADDPGState": "maddpg",
    "ReplayBuffer": "maddpg",
    "MATD3": "matd3",
    "MATD3Config": "matd3",
    "MASAC": "masac",
    "MASACConfig": "masac",
    "MASACState": "masac",
    "QMix": "qmix",
    "QMixConfig": "qmix",
    "QMixState": "qmix",
    "RMAPPO": "rmappo",
    "RMAPPOConfig": "rmappo",
    "RunnerCarry": "rmappo",
    "RMADDPG": "rmaddpg",
    "RMADDPGConfig": "rmaddpg",
    "EpisodeBuffer": "rmaddpg",
    "RQMix": "rqmix",
    "RQMixConfig": "rqmix",
    "RMASAC": "rmasac",
    "RMASACConfig": "rmasac",
}

__all__ = list(_WHERE)


def __getattr__(name):
    if name not in _WHERE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_WHERE[name]}", __name__), name)
