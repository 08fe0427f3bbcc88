"""ZeRO-1 in the port (parallel/zero.py) on the CPU: two gloo ranks at
deliver_tiny, one spawn of tests/_torch_ddp_worker.py's `zero` task (each
rank on one torch thread), against the unsharded optimizer on the same
ranks and against the JAX package's replicated step.

- The DDP step (with_cp, dropout and drop path on, grad_accum 2, two
  updates) with the state sharded is bit-equal to the step with the
  unsharded optimizer: losses, gradients and parameters after each
  update. CPU ranks on one thread are deterministic, and each rank
  updates its tensors with the unsharded optimizer's own code.
- After each update, the state gathered on rank 0 is the unsharded
  optimizer's state dict, bit for bit (engine/optim.py's format, so
  checkpoint files do not change).
- Every parameter has exactly one owning rank, the same on both ranks,
  and each rank holds state for exactly the tensors it owns.
- A resume after the first update, from the ZeRO state into the unsharded
  optimizer and from the unsharded state into ZeRO, goes on bit-equal to
  the straight runs.
- The sharded step from the JAX parity weights (dropout 0, grad_accum 1)
  on each rank's half of the batch against JAX's replicated step on the
  whole batch, within tests/test_zero.py's tolerances: loss rtol 1e-5,
  parameters rtol 1e-3 / atol 1e-4.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.engine.optim import make_optimizer
from multimodal_sam_adapter_torch.parallel.zero import (owners,
                                                        shard_optimizer)
from multimodal_sam_adapter_tpu.engine import optim as jopt
from tests import _torch_ddp_worker as w
from tests.test_torch_train_parity import IDX, both  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(both, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("zero")
    torch.save(state_dict_from_jax(both["variables"], IDX), d / "sd.pt")
    torch.save({"img": torch.from_numpy(both["img"]),
                "gt": torch.from_numpy(both["gt"]).long()}, d / "batch.pt")
    return w.spawn("zero", d, d, d / "sd.pt", d / "batch.pt")


def assert_same(a, b, where=""):
    """a and b equal bit for bit: nested dicts, lists and tensors, or the
    worker's digests of them (a tensor's dtype, shape and byte hash)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b.to(a.device)), where
    else:
        assert a == b, where


def test_owners_split_greedily_by_size():
    sizes = [5, 3, 3, 2, 1, 1]
    got = owners(sizes, 2)
    assert got == [0, 1, 1, 0, 1, 0]
    assert [sum(s for s, o in zip(sizes, got) if o == r)
            for r in range(2)] == [8, 7]
    assert owners([4, 4, 4, 4], 3) == [0, 1, 2, 0]
    assert owners(sizes, 1) == [0] * 6


def test_every_parameter_is_owned_and_held_by_exactly_one_rank(ranks):
    owner = ranks[0]["zero"]["owner"]
    assert all(r["zero"]["owner"] == owner for r in ranks)
    n = len(owner)
    assert n == len(ranks[0]["plain"]["params"][0])
    held = [set(r["zero"]["held"]) for r in ranks]
    assert held[0].isdisjoint(held[1]) and held[0] | held[1] == set(range(n))
    for rank, h in enumerate(held):
        assert h == {i for i, o in enumerate(owner) if o == rank}
    # the greedy split keeps the ranks' shares of the elements even
    sizes = ranks[0]["zero"]["sizes"]
    assert sorted(sizes) == sorted(
        int(np.prod(shape))
        for _, shape, _ in ranks[0]["plain"]["params"][0].values())
    share = [sum(s for s, o in zip(sizes, owner) if o == r)
             for r in range(2)]
    assert abs(share[0] - share[1]) <= max(sizes)


def test_sharded_step_is_bit_equal_to_the_unsharded_step(ranks):
    for r in ranks:
        plain, zero = r["plain"], r["zero"]
        assert zero["losses"] == plain["losses"]
        assert len(zero["params"]) == 2
        assert_same(zero["grads"], plain["grads"], "grads")
        assert_same(zero["params"], plain["params"], "params")
        assert_same(zero["stats"], plain["stats"], "stats")
    assert_same(ranks[0]["zero"]["params"], ranks[1]["zero"]["params"])


def test_consolidated_state_is_the_unsharded_state(ranks):
    zero, plain = ranks[0]["zero"]["saved"], ranks[0]["plain"]["saved"]
    for z, p in zip(zero, plain):
        assert_same(z["optimizer"], p["optimizer"], "optimizer")
        assert set(z["optimizer"]["state"]) == set(
            range(len(ranks[0]["zero"]["owner"])))
    assert all(s["optimizer"] is None for s in ranks[1]["zero"]["saved"])


def test_resume_across_zero_and_unsharded_is_bit_equal(ranks):
    for r in ranks:
        for src, dst in (("zero", "plain"), ("plain", "zero")):
            resumed = r[f"{src}_to_{dst}"]
            assert resumed["losses"] == r[dst]["losses"][2:]
            assert_same(resumed["params"][0], r[dst]["params"][1],
                        f"{src}->{dst}")
        assert_same(r["zero_to_plain"]["saved"][0]["optimizer"],
                    r["plain"]["saved"][1]["optimizer"])
    assert_same(ranks[0]["plain_to_zero"]["saved"][0]["optimizer"],
                ranks[0]["plain"]["saved"][1]["optimizer"])


def test_sharded_step_matches_the_jax_replicated_step(both, ranks):  # noqa: F811,E501
    params = both["variables"]["params"]
    tx = jopt.make_optimizer(params, grad_accum_steps=1, **w.OPT)

    @jax.jit
    def update(g, p):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    new = jax.tree.map(np.asarray, update(both["jax_grads"], params))
    want = state_dict_from_jax(
        {"params": new, "batch_stats": jax.tree.map(
            np.asarray, both["variables"]["batch_stats"])}, IDX)
    np.testing.assert_allclose(
        np.mean([r["jax"]["losses"][0] for r in ranks]), both["loss"][1],
        rtol=1e-5)
    for r in ranks:
        (got,) = r["jax"]["params"]
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-3, atol=1e-4, err_msg=name)


def test_one_process_zero_is_the_unsharded_optimizer():
    """Without a process group one rank owns every tensor: the same
    updates and state_dict as the unsharded optimizer, no gathering."""
    def run(zero):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                    torch.nn.Linear(5, 3))
        opt = make_optimizer(model, num_layers=1, steps_per_epoch=2,
                             max_epochs=2, warmup_epochs=0)
        if zero:
            opt = shard_optimizer(opt)
            assert opt.world == 1 and all(map(opt.owns, opt._params()))
        for _ in range(2):
            model(torch.randn(4, 6)).square().sum().backward()
            opt.step()
        return model.state_dict(), opt.state_dict()

    assert_same(run(True), run(False))
