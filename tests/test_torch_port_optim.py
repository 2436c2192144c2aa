"""The port's optimizer (go_with_the_flows_tpu_torch/optim.py) against
the JAX package's optax transform, on the CPU: the cosine schedule at
many steps, and five AmsgradWD steps on a small tree in which one leaf
has no gradient on some steps and another an all-zero one, so that the
per-leaf count gating is exercised. Parameters to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from go_with_the_flows_tpu import optim as jo
from go_with_the_flows_tpu_torch import optim as to

HP = dict(epoch_length=3, cycle_length=2, min_lr=1e-3, max_lr=5e-3,
          beta1=0.9, min_beta2=0.99, max_beta2=0.999, wd=1e-2)


@pytest.mark.parametrize("epoch_length,cycle_length", [(3, 2), (7, 5)])
def test_schedule_matches_jax(epoch_length, cycle_length):
    want = jo.cosine_cycle_schedule(epoch_length, cycle_length, 1e-4, 2e-3)
    got = to.cosine_cycle_schedule(epoch_length, cycle_length, 1e-4, 2e-3)
    steps = range(0, 4 * epoch_length * cycle_length + 3)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6)


def test_amsgrad_steps_match_jax():
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    # leaf b: no gradient at steps 1 and 3 (None in torch, zeros in JAX);
    # leaf c: an all-zero gradient at step 2
    absent = {(1, "b"), (3, "b")}
    for t, k in absent:
        grads[t][k] = np.zeros(shapes[k], np.float32)
    grads[2]["c"] = np.zeros(shapes["c"], np.float32)

    opt = jo.make_optimizer(**HP)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = to.make_optimizer(list(tp.values()), **HP)
    for t in range(5):
        deltas, state = opt.update(jax.tree.map(jnp.asarray, grads[t]),
                                   state, jp)
        jp = optax.apply_updates(jp, deltas)
        for k, p in tp.items():
            p.grad = (None if (t, k) in absent
                      else torch.from_numpy(grads[t][k]))
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=f"step {t} leaf {k}")
    assert topt.global_step == 5
    assert topt.counts.tolist() == [5, 3, 4]
