"""Policy/value networks.

The reference uses SB2's MlpPolicy (two 64-unit tanh layers) over the
LidarInFront vector (reference ``tests/train.py:122``).  ``ActorCritic``
keeps that interface with configurable widths: separate tanh towers for the
policy logits and the value, in plain JAX.

The parameter tree is ``{"params": {"pi_0", ..., "pi_out", "v_0", ...,
"v_out": {"kernel": [in, out], "bias": [out]}}}`` — the layout of the shipped
``trained_agents/*`` checkpoints — and new layers are initialised with a
truncated LeCun-normal kernel and a zero bias.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    n_actions: int
    hidden: Sequence[int] = (64, 64)

    def _layers(self, in_dim: int):
        """(name, in, out) of every dense layer, policy tower first."""
        out = []
        for tower, head in (("pi", self.n_actions), ("v", 1)):
            d = in_dim
            for i, h in enumerate(self.hidden):
                out.append((f"{tower}_{i}", d, h))
                d = h
            out.append((f"{tower}_out", d, head))
        return out

    def init(self, key, obs):
        """Fresh variables for observations shaped like ``obs`` [..., D]."""
        kernel_init = jax.nn.initializers.lecun_normal()
        layers = self._layers(obs.shape[-1])
        params = {}
        for k, (name, d_in, d_out) in zip(jax.random.split(key, len(layers)),
                                          layers):
            params[name] = {"kernel": kernel_init(k, (d_in, d_out),
                                                  jnp.float32),
                            "bias": jnp.zeros((d_out,), jnp.float32)}
        return {"params": params}

    def apply(self, variables, obs):
        """``obs [..., D] -> (logits [..., A], value [...])``."""
        p = variables["params"]
        x = obs.astype(jnp.float32)

        def tower(name):
            h = x
            for i in range(len(self.hidden)):
                h = jnp.tanh(h @ p[f"{name}_{i}"]["kernel"]
                             + p[f"{name}_{i}"]["bias"])
            return h @ p[f"{name}_out"]["kernel"] + p[f"{name}_out"]["bias"]

        return tower("pi"), tower("v")[..., 0]
