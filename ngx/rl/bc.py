"""Behavior-cloning pretrain from recorded expert demonstrations.

The reference optionally warm-starts PPO2 from an SB2 ``ExpertDataset``
``.npz`` before ``model.learn`` (reference ``tests/train.py:125-132``;
recorder ``tests/record_expert_demonstrations.py:30-68``).  This is the
batched counterpart: the whole supervised pass — minibatch sampling,
cross-entropy on the policy head, Adam — is one jitted ``lax.scan`` over
update steps; the dataset lives on-device for the duration.

The ``.npz`` layout is the one ``ngx.cli.record_demos`` writes (and SB2's
``generate_expert_traj`` wrote): ``obs [N, obs_dim]``, ``actions [N, 1]``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax


def load_demos(path):
    """Load an ExpertDataset-layout .npz into (obs[N,D] f32, actions[N] i32)."""
    with np.load(path) as z:
        obs = np.asarray(z["obs"], np.float32)
        actions = np.asarray(z["actions"], np.int64).reshape(-1)
    assert obs.shape[0] == actions.shape[0], "obs/actions length mismatch"
    return obs, actions


def pretrain(model, params, obs, actions, key=None, steps: int = 500,
             batch_size: int = 256, lr: float = 1e-3):
    """Supervised pretrain of the policy head on (obs, actions).

    Returns (params, metrics) where metrics holds the final cross-entropy
    loss and training-set action accuracy.  Mirrors SB2's ``model.pretrain``
    (policy cross-entropy only; the value head is left for PPO to fit).
    """
    key = jax.random.key(0) if key is None else key
    # the dataset rides as ARGUMENTS (device_put), never as closed-over trace
    # constants, so the program does not embed (and recompile on) the data
    obs = jax.device_put(jnp.asarray(obs, jnp.float32))
    actions = jax.device_put(jnp.asarray(actions, jnp.int32))
    N = obs.shape[0]
    bs = min(batch_size, N)
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p, o, a):
        logits, _ = model.apply(p, o)
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, a[:, None], axis=1).mean()
        acc = (logits.argmax(-1) == a).mean()
        return ce, acc

    @jax.jit
    def run(params, opt_state, key, obs, actions):
        def body(carry, key_t):
            params, opt_state = carry
            idx = jax.random.randint(key_t, (bs,), 0, N)
            (ce, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, obs[idx], actions[idx])
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), (ce, acc)

        (params, opt_state), (ce, acc) = jax.lax.scan(
            body, (params, opt_state), jax.random.split(key, steps))
        full_ce, full_acc = loss_fn(params, obs, actions)
        return params, {"loss": full_ce, "accuracy": full_acc,
                        "first_loss": ce[0], "last_loss": ce[-1]}

    params, metrics = run(params, opt_state, key, obs, actions)
    return params, {k: float(v) for k, v in metrics.items()}


def pretrain_from_npz(model, params, npz_path, **kw):
    """Convenience wrapper: load the .npz and pretrain."""
    obs, actions = load_demos(npz_path)
    return pretrain(model, params, obs, actions, **kw)
