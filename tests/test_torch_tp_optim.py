"""The optimizer's two memory modes under tensor parallelism, float32 on
the CPU: the factored second moment (engine/optim.py) and ZeRO-1 on the
data group (parallel/zero.py), on a model sharded by
parallel/tp.py:shard_segmentor_.

deliver_tiny at a ViT width of 128 with 4 heads
(tests/_torch_ddp_worker.py:WIDE), where the split tensors factor, from
the JAX parity weights on the JAX batch, dropout 0, grad_accum 1, one
spawn of four gloo ranks (the `tp_optim` task):

- against JAX's own sharded step on four virtual CPU devices
  (shard_params_tp, make_optimizer(..., factored_second_moment=...),
  shard_opt_state for ZeRO; `jax_steps`): the
  factored moment, ZeRO and both on a (data 2, model 2) mesh, the
  factored moment on (data 1, model 4); loss rtol 1e-5, parameters after
  the update rtol 1e-3 / atol 2.5e-4, BatchNorm statistics rtol 1e-5 /
  atol 1e-7 (tests/test_torch_train_parity.py's bars);
- against the port's one-process step on the global batch: the loss,
  and the update (parameters after minus before) as a whole within
  STEP_REL relative L2 of the one-process update; given the gradients
  the ranks saw, each tensor's update within SAME_GRADS_REL of the
  unsharded optimizer's;
- ZeRO bit-equal to the same ranks' step without it, its owners equal
  across the model ranks;
- the state gathered partway through an accumulation (ZeRO over the
  data group, then the model group), written as a checkpoint and cut
  back to the shares resumes bit-equal; the gathered state is the
  unsharded optimizer's given the gathered gradients;
- three mutants leave the SAME_GRADS_REL bar: the factored axes picked from
  the share's shape, the factored means without the model group's
  all-reduce, ZeRO's owners over every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_sam_adapter_torch.engine import optim
from multimodal_sam_adapter_torch.engine.convert import state_dict_from_jax
from multimodal_sam_adapter_torch.parallel.tp import COLUMN, ROW, Split
from multimodal_sam_adapter_tpu.engine import optim as jopt
from multimodal_sam_adapter_tpu.models.segmentor import (
    EncoderDecoder as JaxEncoderDecoder)
from tests import _torch_ddp_worker as ddp_worker
from tests._torch_parity import randomize

CFG = ddp_worker.wide_model()
BACKBONE = CFG["backbone"]
IDX = BACKBONE["interaction_indexes"]
B, S = 2, BACKBONE["img_size"]
MODES = ddp_worker.TP_OPTIM_MODES
# the update as a whole within this relative L2 of the one-process
# step's: the first update of a tensor whose gradient is round-off is
# about its sign, and the factored mode's unfactored 1-D moment (epsilon
# 1e-30 under the root, where Adam's 1e-8 sits outside it) takes the sign
# of gradients far below Adam's floor (the k bias of qkv: 0.43)
STEP_REL = {"adam": 1e-3, "factored": 3e-2}
# each tensor's update within this relative L2 of the unsharded
# optimizer's on the same gradients
SAME_GRADS_REL = 1e-5
# the cases held against JAX's sharded step: (data, model, mode)
JAX_CASES = [(2, 2, "factored"), (2, 2, "zero"), (2, 2, "factored_zero"),
             (1, 4, "factored")]
RANK_CASES = [(2, 2, m) for m in MODES] + [(1, 4, "factored"),
                                           (1, 4, "factored_zero")]


@pytest.fixture(scope="module")
def wide():
    """The JAX model at WIDE's width, its parity weights and batch."""
    jm = JaxEncoderDecoder(num_classes=CFG["num_classes"],
                           head_channels=CFG["head_channels"],
                           dropout_ratio=0.0, backbone_cfg=BACKBONE)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 6)), train=False))
    variables = randomize(shapes, 1)
    rng = np.random.default_rng(0)
    img = (rng.standard_normal((B, S, S, 6)) * 0.5).astype(np.float32)
    gt = rng.integers(0, CFG["num_classes"], (B, S, S)).astype(np.int32)
    gt[rng.random((B, S, S)) < 0.1] = 255
    return dict(jm=jm, variables=variables, img=img, gt=gt,
                sd=state_dict_from_jax(variables, IDX))


@pytest.fixture(scope="module")
def jax_steps(wide):
    """(data, model, mode) -> JAX's sharded step's loss and its state
    after the update (parameters and statistics) as a state dict. The
    step is engine/train.py:make_train_step's, in two jits to compile the
    model once: the loss, the gradients and the statistics on the (2, 2)
    mesh (shard_params_tp, the batch on 'data'), then each mode's optax
    update (make_optimizer, shard_opt_state for ZeRO) on its own mesh,
    with the gradients placed as its parameters are."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimodal_sam_adapter_tpu.parallel.mesh import make_mesh
    from multimodal_sam_adapter_tpu.parallel.tp import shard_params_tp
    from multimodal_sam_adapter_tpu.parallel.zero import shard_opt_state

    jm, variables = wide["jm"], wide["variables"]

    def loss_fn(params, stats, img, gt):
        (loss, _), upd = jm.apply(
            {"params": params, "batch_stats": stats}, img, gt,
            method=jm.loss, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return loss, upd["batch_stats"]

    def mesh_of(data, model):
        return make_mesh(("data", "model"), shape=(data, model),
                         devices=jax.devices()[:4])

    mesh = mesh_of(2, 2)
    rows = NamedSharding(mesh, P("data"))
    with jax.default_matmul_precision("highest"):
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(
                shard_params_tp(variables["params"], mesh),
                jax.device_put(variables["batch_stats"],
                               NamedSharding(mesh, P())),
                jax.device_put(jnp.asarray(wide["img"]), rows),
                jax.device_put(jnp.asarray(wide["gt"]), rows))
    stats = jax.tree.map(np.asarray, stats)
    out = {}
    for data, model, mode in JAX_CASES:
        factored, zeroed = MODES[mode]
        mesh = mesh_of(data, model)
        params = shard_params_tp(variables["params"], mesh)
        g = jax.tree.map(lambda t, p: jax.device_put(t, p.sharding), grads,
                         params)
        tx = jopt.make_optimizer(params, grad_accum_steps=1,
                                 factored_second_moment=factored,
                                 **ddp_worker.OPT)
        opt_state = tx.init(params)
        if zeroed:
            opt_state = shard_opt_state(opt_state, mesh)

        @jax.jit
        def update(g, opt_state, params):
            upd, _ = tx.update(g, opt_state, params)
            return optax.apply_updates(params, upd)

        new = jax.tree.map(np.asarray, update(g, opt_state, params))
        out[(data, model, mode)] = (float(loss), state_dict_from_jax(
            {"params": new, "batch_stats": stats}, IDX))
    return out


@pytest.fixture(scope="module")
def reference(wide):
    """The port's one-process update of the global batch, Adam's and the
    factored moment's, on one torch thread as the ranks run."""
    batch = {"img": torch.from_numpy(wide["img"]),
             "gt": torch.from_numpy(wide["gt"]).long()}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, opt in (("adam", ddp_worker.OPT),
                          ("factored", ddp_worker.FACTORED)):
            run = ddp_worker.train_run(CFG, [batch], 1, state_dict=wide["sd"],
                                       opt=opt)
            out[name] = run["params"][0]
            out["loss"] = run["losses"][0]
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(wide, reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_optim")
    torch.save(wide["sd"], d / "sd.pt")
    torch.save({"img": torch.from_numpy(wide["img"]),
                "gt": torch.from_numpy(wide["gt"]).long()}, d / "batch.pt")
    torch.save(reference, d / "ref.pt")
    return ddp_worker.spawn("tp_optim", d, d, d / "sd.pt", d / "batch.pt",
                            d / "ref.pt", world=4,
                            timeout=ddp_worker.TP_OPTIM_TIMEOUT)


def test_factored_axes_come_from_the_whole_tensor():
    """At 4 model ranks qkv's share (96, 128) alone would not factor and
    lin1's (128, 128) would pick other axes: the whole tensor decides
    (`logical_shape`), and each moment vector is split where the mean
    did not run along the split axis (`moment_split`)."""
    class Mesh4:
        model = 4

    qkv = torch.nn.Parameter(torch.zeros(96, 128))
    qkv.tp_split, qkv.tp_mesh = Split(0, 3), Mesh4()
    lin2 = torch.nn.Parameter(torch.zeros(128, 128))
    lin2.tp_split, lin2.tp_mesh = ROW, Mesh4()
    assert optim._factored_dims((96, 128)) is None
    assert optim.logical_shape(qkv) == (384, 128)
    assert optim._factored_dims((384, 128)) == (1, 0)
    assert optim._factored_dims((128, 128)) == (0, 1)
    assert optim.logical_shape(lin2) == (128, 512)
    # qkv: v_row is the mean over the split axis, whole on every rank;
    # v_col is indexed by it, split as the tensor is
    assert optim.moment_split("v_row", (384, 128), Split(0, 3)) is None
    assert optim.moment_split("v_col", (384, 128), Split(0, 3)) == Split(
        0, 3)
    # lin2 (128, 512) split on its input axis 1: v_row (over axis 1) is
    # whole, v_col (over axis 0) is split on its only axis
    assert optim.moment_split("v_row", (128, 512), ROW) is None
    assert optim.moment_split("v_col", (128, 512), ROW) == COLUMN
    assert optim.moment_split("mu", (128, 512), ROW) == ROW
    assert optim.moment_split("v", (96, 32), COLUMN) == COLUMN


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: f"{c}")
def test_tp_optimizer_matches_the_jax_sharded_step(ranks, jax_steps, case):
    data, model, mode = case
    loss, want = jax_steps[case]
    got = [r[case] for r in ranks]
    losses = [g["losses"][0] for g in got if g["model_rank"] == 0]
    assert len(losses) == data
    np.testing.assert_allclose(np.mean(losses), loss, rtol=1e-5)
    params = got[0]["params"]
    assert params and set(params) <= set(want)
    for name, t in params.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=2.5e-4, err_msg=name)
    stats = got[0]["stats"]
    for name, t in stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", RANK_CASES, ids=lambda c: f"{c}")
def test_tp_optimizer_matches_the_one_process_step(reference, ranks, case):
    """The data ranks' mean loss is the one-process step's, the update as
    a whole within STEP_REL of its update, and every rank holds the same
    gathered parameters. (Tensor by tensor the two steps' updates part
    where a gradient is round-off; the next test holds each tensor on the
    same gradients.)"""
    got = [r[case] for r in ranks]
    data = case[0]
    losses = [g["losses"][0] for g in got if g["model_rank"] == 0]
    assert len(losses) == data
    np.testing.assert_allclose(np.mean(losses), reference["loss"], rtol=1e-5)
    bar = STEP_REL[ddp_worker.optimizer_of(case[2])]
    for g in got:
        assert g["rel"]["*"] <= bar, g["rel"]["*"]
        assert g["params_digest"] == got[0]["params_digest"]


@pytest.mark.parametrize("case", RANK_CASES, ids=lambda c: f"{c}")
def test_tp_optimizer_is_the_unsharded_optimizer_on_its_gradients(ranks,
                                                                  case):
    """Given the gradients the ranks' step saw (gathered), the unsharded
    optimizer makes the ranks' update, tensor by tensor, within
    SAME_GRADS_REL (the model group's float32 sums in place of one mean)."""
    for r in ranks:
        rel = dict(r[case]["same_grads"])
        rel.pop("*")
        worst = max(rel, key=rel.get)
        assert rel[worst] <= SAME_GRADS_REL, (worst, rel[worst])


@pytest.mark.parametrize("shape,zeroed,plain", [
    ((2, 2), "zero", "adam"), ((2, 2), "factored_zero", "factored"),
    ((1, 4), "factored_zero", "factored")])
def test_zero_under_tp_is_bit_equal_to_the_unsharded_optimizer(
        ranks, shape, zeroed, plain):
    for r in ranks:
        assert r[shape + (zeroed,)]["params_digest"] == r[shape + (
            plain,)]["params_digest"]


@pytest.mark.parametrize("mode", ["zero", "factored_zero"])
def test_zero_owners_are_the_same_data_rank_on_every_model_rank(ranks,
                                                                 mode):
    """The owners span the data group (ranks 0 and 1 of it), the model
    ranks' shares of a tensor have one owner, and each rank holds the
    state of the tensors its data rank owns and no other."""
    got = [r[(2, 2, mode)] for r in ranks]
    owner = got[0]["owner"]
    assert set(owner) == {0, 1}
    for g in got:
        assert g["owner"] == owner
        assert g["sizes"] == got[0]["sizes"]
        assert g["held"] == [i for i, o in enumerate(owner)
                             if o == g["data_rank"]]
    from multimodal_sam_adapter_torch.parallel.zero import owners
    assert owners(got[0]["sizes"], 2) == owner


def test_tp_optimizer_checkpoint_resumes_bit_equal(ranks):
    from multimodal_sam_adapter_torch.engine.optim import make_optimizer
    from multimodal_sam_adapter_torch.models.segmentor import build_segmentor

    got = [r["ckpt"] for r in ranks]
    for g in got:
        assert g["restored_equal"] and g["resumed_equal"]
        assert g["state"] == got[0]["state"]
        assert g["counts"] == (2, 2)
    g = got[0]
    # the gathered state is the unsharded optimizer's given the gathered
    # gradients: the same entries, within the round-off of the model
    # group's sums (the bf16 first moment within one of its ulps)
    gathered, plain = g["gathered"], g["plain"]
    assert gathered["accum"] == plain["accum"]
    assert set(gathered["state"]) == set(plain["state"])
    keys = set()
    for i, st in plain["state"].items():
        assert set(gathered["state"][i]) == set(st), i
        for k, v in st.items():
            keys.add(k)
            w = gathered["state"][i][k]
            assert w.dtype == v.dtype and w.shape == v.shape, (i, k)
            tol = (dict(rtol=8e-3, atol=1e-9) if k == "mu"
                   else dict(rtol=1e-4, atol=1e-12))
            np.testing.assert_allclose(w.float().numpy(), v.float().numpy(),
                                       err_msg=f"{i} {k}", **tol)
    assert {"mu", "v", "v_row", "v_col"} <= keys
    # the parameters after the two updates: the second reads the bf16
    # first moment, where a last-bit difference of the first update's can
    # round to the neighbouring bf16 value for a few elements
    rel = dict(g["params_rel"])
    rel.pop("*")
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 10 * SAME_GRADS_REL, (worst, rel[worst])
    # the gathered state loads into the unsharded optimizer
    model = build_segmentor(CFG, "cpu", generator=torch.Generator()
                            .manual_seed(0))
    opt = make_optimizer(model, **dict(ddp_worker.FACTORED,
                                       grad_accum_steps=2))
    opt.load_state_dict(gathered)
    assert opt.updates == 2 and opt.factored


@pytest.mark.parametrize("mutant", ["own_axes", "no_model_sum",
                                    "owners_over_world"])
def test_the_tp_optimizer_check_sees_a_broken_mode(ranks, mutant):
    """The factored axes from the share's shape at 4 model ranks, the
    factored means without the model group's all-reduce, ZeRO's owners
    over every rank: an update leaves the SAME_GRADS_REL bar."""
    for r in ranks:
        assert max(r[mutant].values()) > SAME_GRADS_REL, mutant
