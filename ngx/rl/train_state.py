"""The optimiser state a trainer carries: params, optax state, step count."""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: Any
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, params, tx):
        return cls(step=jnp.int32(0), params=params,
                   opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads):
        """One optimiser step: ``params <- params + tx.update(grads)``."""
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return dataclasses.replace(
            self, step=self.step + 1,
            params=optax.apply_updates(self.params, updates),
            opt_state=opt_state)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


jax.tree_util.register_dataclass(TrainState,
                                 data_fields=["step", "params", "opt_state"],
                                 meta_fields=["tx"])
