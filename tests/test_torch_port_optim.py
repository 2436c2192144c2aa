"""The port's optimizer (go_with_the_flows_tpu_torch/optim.py) against
the JAX package's optax transform, on the CPU: the cosine schedule at
many steps, and five AmsgradWD steps on a small tree in which one leaf
has no gradient on some steps and another an all-zero one, so that the
per-leaf count gating is exercised. Parameters to 1e-6. Then the
optimizer's checkpoint: save, load and step against steps without a
break, bit for bit."""

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


def _resume_run(tmp_path, hp, n_steps, split):
    """`n_steps` AmsgradWD steps on a small model with seeded gradients
    (leaf "b" has none at step 1), taking a `torch.save` / `torch.load`
    round trip into a fresh model and optimizer after `split` steps
    (no break if split is None). Returns the model and optimizer."""
    rng = np.random.RandomState(1)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(n_steps)]

    def fresh():
        model = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
             for k, v in init.items()})
        return model, to.make_optimizer(list(model.values()), **hp)

    model, opt = fresh()
    for t in range(n_steps):
        if t == split:
            path = tmp_path / "ckpt.pt"
            torch.save({"model": model.state_dict(),
                        "optimizer": opt.state_dict()}, path)
            model, opt = fresh()
            ckpt = torch.load(path)
            model.load_state_dict(ckpt["model"])
            opt.load_state_dict(ckpt["optimizer"])
        for k, p in model.items():
            p.grad = (None if (t, k) == (1, "b")
                      else torch.from_numpy(grads[t][k]))
        opt.step()
    return model, opt


@pytest.mark.parametrize("constant", [False, True])
def test_amsgrad_state_survives_save_and_load(tmp_path, constant):
    """6 steps without a break against 3, save, load into a fresh model and
    optimizer, 3 more: parameters, moments, counts and the global step
    equal bit for bit. The scheduled case crosses epoch and cycle
    boundaries (epoch_length 2, cycle_length 2); the constant one gives
    lr and b2 as plain floats."""
    hp = dict(HP, epoch_length=2, cycle_length=2)
    if constant:
        hp.update(min_lr=3e-3, max_lr=3e-3, min_beta2=0.995, max_beta2=0.995)
    whole, whole_opt = _resume_run(tmp_path, hp, 6, None)
    resumed, resumed_opt = _resume_run(tmp_path, hp, 6, 3)
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k
    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "counts"):
        assert torch.equal(getattr(whole_opt, k), getattr(resumed_opt, k)), k
    assert whole_opt.global_step == resumed_opt.global_step == 6
    assert whole_opt.counts.tolist() == [6, 5, 6]
    if not constant:
        lr = resumed_opt.param_groups[0]["lr"]
        assert lr(0) != lr(3)  # the schedule came back through the load


def test_amsgrad_constant_lr_steps_like_a_flat_schedule():
    """lr and b2 given as floats step exactly as a schedule whose minimum
    and maximum are those floats."""
    out = []
    for lr, b2 in ((2e-3, 0.99), (to.cosine_cycle_schedule(3, 2, 2e-3, 2e-3),
                                  to.cosine_cycle_schedule(3, 2, 0.99, 0.99))):
        p = torch.nn.Parameter(torch.arange(6, dtype=torch.float32))
        opt = to.AmsgradWD([p], lr=lr, b2=b2, weight_decay=1e-2)
        for t in range(4):
            p.grad = torch.full_like(p, 0.5 - t)
            opt.step()
        out.append(p.detach().clone())
    assert torch.equal(out[0], out[1])


def test_amsgrad_load_rejects_another_models_state():
    a = [torch.nn.Parameter(torch.zeros(3))]
    b = [torch.nn.Parameter(torch.zeros(4))]
    state = to.make_optimizer(a, **HP).state_dict()
    with pytest.raises(ValueError, match="exp_avg"):
        to.make_optimizer(b, **HP).load_state_dict(state)
