"""Data parallelism in the port (parallel/ddp.py), on the CPU: two gloo
ranks on localhost at deliver_tiny, each holding one sample, against one
process holding the global batch of both in rank order (the rule the JAX
package's mesh keeps, tests/test_multiprocess_train.py). Drop path and
dropout at the config's rates, with_cp on, seeded random weights.

- the step (grad_accum 1): the mean of the ranks' losses equals the
  global batch's loss (rtol 1e-5), every gradient DDP hands the optimizer
  equals the single process's within 1e-4 of the largest |g| of its
  tensor (+ 1e-9: the biases in front of a BatchNorm have a true gradient
  of 0, computed as round-off near 1e-12), the BatchNorm running
  statistics within rtol 1e-5, on both ranks; and the same check fails
  when the BatchNorm's all-reduce is taken out (each rank then normalises
  with its own sample's statistics);
- grad_accum 2, two updates (no_sync on the first micro-step of each):
  every parameter tensor within 1e-4 relative L2 of the single process's
  after each update, and equal on both ranks. Relative L2, not per
  element: a deformable-attention sampling location that lands within
  round-off of a pixel edge takes a gradient from the other side of the
  bilinear kink in one of the two runs, and Adam turns that element's
  difference into a step of up to lr (the JAX package's own two-process
  test allows 2.5e-4 per element for the same reason); here 4 elements
  of the last injector's 1,536 offsets move by ~1e-5;
- the port's BatchNorm2d alone: forward, input gradient, parameter
  gradients (summed over the ranks, as DDP's average sums them over a
  mean loss) and running statistics of the ranks equal one process's on
  the concatenated batch (rtol 1e-5 / atol 1e-6), and the layer equals
  torch's BatchNorm2d in one process but for the running variance, which
  is the biased one;
- init_distributed: a no-op without torchrun's environment, and NCCL
  refused without a card and for ranks that share one.

The ranks and the reference run torch on one thread.
"""
import numpy as np
import pytest
import torch

from multimodal_sam_adapter_torch import parallel
from multimodal_sam_adapter_torch.parallel import ddp
from tests import _torch_ddp_worker as w


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.spawn("step", tmp_path_factory.mktemp("ddp_step"))


@pytest.fixture(scope="module")
def reference():
    batches = w.global_batches(4)
    model = w.tiny_model()
    return {"one": w.train_run(model, batches[:1], 1),
            "accum": w.train_run(model, batches, 2)}


def assert_step_matches(got, want):
    """A rank's one-step results against the single process's: the
    ranks' mean loss, the update's gradients, the BatchNorm statistics."""
    np.testing.assert_allclose(np.mean(got["losses"]), want["losses"][0],
                               rtol=1e-5)
    (g,), (ref,) = got["grads"], want["grads"]
    for n, t in ref.items():
        err = (g[n] - t).abs().max().item()
        assert err <= 1e-4 * t.abs().max().item() + 1e-9, (n, err)
    for n, t in want["stats"].items():
        if n.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got["stats"][n], t, rtol=1e-5,
                                       atol=1e-7, msg=n)


def _merged(results, key):
    """Both ranks' losses in one list (rank order), the rest of rank r."""
    r = dict(results[0][key])
    r["losses"] = [np.mean([res[key]["losses"][i] for res in results])
                   for i in range(len(r["losses"]))]
    return r


def test_ranks_hold_the_global_batch_step(ranks, reference):
    for rank in range(2):
        got = dict(ranks[rank]["one"])
        got["losses"] = [res["one"]["losses"][0] for res in ranks]
        assert_step_matches(got, reference["one"])
    # DDP hands every rank the same gradients
    for n, t in ranks[0]["one"]["grads"][0].items():
        assert torch.equal(t, ranks[1]["one"]["grads"][0][n]), n


def test_the_check_sees_a_missing_batchnorm_sync(ranks, reference):
    got = dict(ranks[0]["unsynced"])
    got["losses"] = [res["unsynced"]["losses"][0] for res in ranks]
    with pytest.raises(AssertionError):
        assert_step_matches(got, reference["one"])


def test_accumulated_updates_match_the_global_batch(ranks, reference):
    want = reference["accum"]
    got = _merged(ranks, "accum")
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert len(want["params"]) == len(got["params"]) == 2
    for k in range(2):
        for n, t in want["params"][k].items():
            rel = ((got["params"][k][n] - t).norm() / t.norm()).item()
            assert rel <= 1e-4, (k, n, rel)
            assert torch.equal(got["params"][k][n],
                               ranks[1]["accum"]["params"][k][n]), n


def test_batchnorm_layer_sums_over_the_ranks(ranks):
    x, dy = w.bn_inputs()
    want = w.bn_run(x, dy)
    got = [r["bn"] for r in ranks]
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([g[key] for g in got]),
                                   want[key], rtol=1e-5, atol=1e-6, msg=key)
    for key in ("dweight", "dbias"):
        torch.testing.assert_close(got[0][key] + got[1][key], want[key],
                                   rtol=1e-5, atol=1e-6, msg=key)
    for key in ("running_mean", "running_var"):
        for g in got:
            torch.testing.assert_close(g[key], want[key], rtol=1e-5,
                                       atol=1e-7, msg=key)


def test_batchnorm_layer_is_torch_batchnorm_but_the_biased_variance():
    from multimodal_sam_adapter_torch.nn.layers import BatchNorm2d

    x, dy = w.bn_inputs()
    ours = w.bn_run(x, dy)
    ref = torch.nn.BatchNorm2d(8).train()
    port = BatchNorm2d(8)
    assert isinstance(port, torch.nn.BatchNorm2d)
    assert list(port.state_dict()) == list(ref.state_dict())
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5,
                            generator=torch.Generator().manual_seed(4))
        ref.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(5))
    xr = x.clone().requires_grad_()
    y = ref(xr)
    y.backward(dy)
    torch.testing.assert_close(ours["y"], y.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ours["dx"], xr.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ours["dweight"], ref.weight.grad, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(ours["running_mean"], ref.running_mean,
                               rtol=1e-6, atol=1e-7)
    n = x.numel() // x.shape[1]
    biased = x.transpose(0, 1).reshape(8, -1).var(1, unbiased=False)
    torch.testing.assert_close(ours["running_var"], 0.9 + 0.1 * biased,
                               rtol=1e-5, atol=1e-7)
    # torch's running variance takes the unbiased one
    torch.testing.assert_close(ref.running_var,
                               0.9 + 0.1 * biased * n / (n - 1),
                               rtol=1e-5, atol=1e-7)
    # eval mode: torch's BatchNorm on the running statistics
    port.load_state_dict(ref.state_dict())
    port.eval(), ref.eval()
    torch.testing.assert_close(port(x), ref(x), rtol=0, atol=0)


def test_init_distributed_is_a_no_op_without_torchrun(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.init_distributed("gloo") == (0, 1)
    assert parallel.init_distributed("nccl") == (0, 1)
    assert not torch.distributed.is_initialized()
    assert parallel.rank_world() == (0, 1) and parallel.is_main()
    parallel.barrier()
    model = torch.nn.Linear(2, 2)
    assert parallel.wrap_model(model) is model
    a = np.arange(4.0)
    assert np.array_equal(parallel.all_reduce_sum(a), a)
    with pytest.raises(ValueError, match="backend"):
        parallel.init_distributed("mpi")


def test_init_distributed_refuses_nccl_without_a_card_or_on_a_shared_one(
        monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ddp.init_distributed("nccl")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ddp.rank_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="two ranks on one device"):
        ddp.init_distributed("nccl")
    assert not torch.distributed.is_initialized()
    # one rank a card: its card is cuda:LOCAL_RANK % count
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert ddp.rank_device() == torch.device("cuda", 1)


def test_launch_ranks_sets_torchruns_environment_and_kills_at_the_limit():
    import sys
    import time

    cmd = [sys.executable, "-c", "import os; print(*(os.environ[k] for k in "
           "('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR')))"]
    ranks = ddp.launch_ranks(cmd, 3, 60)
    assert [rc for rc, _ in ranks] == [0, 0, 0]
    assert [log.split() for _, log in ranks] == [
        [str(r), "3", str(r), "localhost"] for r in range(3)]
    t = time.monotonic()
    ranks = ddp.launch_ranks([sys.executable, "-c",
                              "import time; time.sleep(60)"], 2, 1)
    assert [rc for rc, _ in ranks] == [None, None]
    assert time.monotonic() - t < 30


def test_launch_ranks_holds_the_rendezvous_port_its_ranks_meet_at():
    """The ranks' MASTER_PORT is bound by the launch before they start (no
    rank, nor any other process, can bind it: no second group can form
    there), and the ranks meet at it as clients of the launch's store:
    a gloo all-reduce over three ranks."""
    import sys

    code = (
        "import os, socket, torch, torch.distributed as dist\n"
        "s = socket.socket()\n"
        "try:\n"
        "    s.bind(('localhost', int(os.environ['MASTER_PORT'])))\n"
        "    held = False\n"
        "except OSError:\n"
        "    held = True\n"
        "s.close()\n"
        "dist.init_process_group('gloo')\n"
        "t = torch.ones(1) * (dist.get_rank() + 1)\n"
        "dist.all_reduce(t)\n"
        "dist.destroy_process_group()\n"
        "print('held', held, 'sum', int(t.item()))\n")
    ranks = ddp.launch_ranks([sys.executable, "-c", code], 3, 120)
    assert [rc for rc, _ in ranks] == [0, 0, 0], ranks
    assert [log.split()[-4:] for _, log in ranks] == [
        ["held", "True", "sum", "6"]] * 3
