"""Sharded actor-learner (PPO) for the batched engine.

The reference trains with stable-baselines-2 PPO2 on TF1, stepping one Python
env at a time (reference ``tests/train.py:92-137``).  Here acting and learning
are one jitted program: the policy rolls the whole on-device env batch with a
``lax.scan``, GAE and the clipped-PPO update run on the same device, and the
batch shards over the ``env`` mesh axis — the gradient all-reduce is the only
cross-device traffic.
"""

from .models import ActorCritic  # noqa: F401
from .train import PPOConfig, make_train, dryrun  # noqa: F401
from .train_state import TrainState  # noqa: F401
