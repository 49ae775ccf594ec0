"""The CUDA kernels on the card: ``conv3d_p`` against ``conv3d_plain``,
``conv3d_dw`` and ``conv_dw_folded`` (fp32 and bf16) against
``conv_dw_plain``, at ragged shapes (channel counts that are not multiples
of the kernels' 16- or 32-row chunks or 32/64/128-wide tiles, position
counts that are not multiples of a row tile or of a slab, an output
smaller than one m16 x n8 tensor-core fragment, K from 1 to 7); the weight
gradients' bitwise repeatability; ``conv3d_p`` (forward and dx) and
``conv3d_dw`` on inputs 4 bytes off 16-byte alignment; the wrappers'
checks and the forward's C entry refusing a launch it cannot run; the
Predictor and
a smoke16 train step on the card against the same on the CPU; a checkpoint
saved while steps run, and restored onto the card; the resident split's
draw against the host gather and the cube rotations against the CPU; an
``fp16_scaled`` step that overflows skipped bitwise on the card; the int8
Predictor's weights resident on the card as int8; the serving programs
(one CUDA graph per bucket and precision) bitwise the eager forward, with
the forward kernel inside each replay; ``fp16_scaled`` steps, applied and
skipped, with no host synchronisation; a weight swap while another thread
replays; the affine warp, the occupancy noise and the device cube codes
on the card against the CPU; k train steps replayed as one CUDA graph
against k eager steps, resident and streamed, with the augmented step
making no host synchronisation; the train loop's pacing waiting on its own
dispatch's event, not on the stream; a SIGTERM during a k = 8 replay
exiting 75 at the group boundary with the state of k eager steps; the
24-pose vote through the graphed kernels against the plain conv at bucket
64, with the device holding one chunk and one staging batch, not 24
rotated copies; the native voxelizer built on the card's host, bitwise the
numpy fill at 64³; the seg64 segmenter's graphed labels bitwise its eager
ones at fp32, bf16 and int8, and its resident train steps (eager, and k =
2 on one graph, with the cube rotation or the paired affine warp) with
finite losses; the paired warp's labels bitwise its plain gather's; the packed serving programs (bit-packed wire batches
unpacked inside one CUDA graph per batch and precision) bitwise their
eager body and the serve program's argmax, with the forward kernel inside
each replay; a stream of frames through POST /predict_voxels_stream
answered with the Predictor's labels and counted by GET /metrics; a
Trainer's run directory on the card (its report, no validation finding,
the readback span only where the pacer waits) and its torch.profiler
window holding the kernels' device events for each traced step; the perf
plane on the card (the peak row keyed by the card's name, a graph's
``program_cost``, a Trainer's MFU window and memory watermark; ``-k perf``);
a served sprint64 burst opening and a recovery closing one incident with
a complete bundle, and an armed service's answers bitwise a dark one's
(``-k incident``); the forward, dx and weight-gradient kernels at one
pod64 data-parallel rank's shapes (batch 128) against the plain versions,
and two steps in a one-rank nccl world bitwise the same steps without a
process group (``-k "pod64_rank or nccl"``); a one-slot ``cli train
--elastic`` whose child trains on the card (``-k elastic``).

These tests need an NVIDIA GPU and skip elsewhere. The repository's
conftest imports JAX, which the GPU machine does not have, so run them
there without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: kernel and plain version sum the same fp32 products in other
orders (TF32 off; a bf16 product is exact in fp32, on the tensor cores as
in SIMT), so they agree to 1e-5 of the output's scale.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,d,h,w,cin,cout,k", [
    (1, 5, 6, 7, 3, 5, 3),
    (2, 8, 8, 8, 17, 33, 3),
    (3, 4, 9, 5, 40, 70, 5),
    (1, 6, 6, 6, 16, 32, 1),
    (2, 9, 9, 9, 8, 96, 7),
    (64, 16, 16, 16, 64, 64, 3),
    (2, 3, 4, 1, 8, 12, 3),  # W=1: the halo on both sides of every row
    (1, 5, 6, 7, 4, 8, 3),  # 16-byte copies, a quarter of a 16-channel chunk
    (2, 6, 5, 4, 12, 20, 3),  # 16-byte copies, three quarters of a chunk
    (1, 16, 16, 16, 32, 32, 3),  # serving's bucket 1: the small tiles
    (1, 16, 16, 16, 64, 64, 3),
    (256, 16, 16, 16, 32, 32, 3),  # sprint64's first block at batch 256
])
def test_kernel_matches_plain(cuda, b, d, h, w, cin, cout, k):
    from featurenet_tpu_torch.ops import conv3d

    g = torch.Generator(device=cuda).manual_seed(b * d + cin)
    x = torch.randn((b, d, h, w, cin), device=cuda, generator=g)
    wt = torch.randn((k, k, k, cin, cout), device=cuda, generator=g)
    before = conv3d.conv3d_fwd_launches
    got = conv3d.conv3d_p(x, wt)
    want = conv3d.conv3d_plain(x, wt)
    torch.cuda.synchronize()
    assert conv3d.conv3d_fwd_launches == before + 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("b,cin,cout", [
    (8, 32, 32), (8, 32, 64), (8, 64, 64), (2, 12, 8), (2, 3, 5),
])
def test_conv3d_p_dx_runs_the_kernel_with_the_flipped_weights(cuda, b, cin, cout):
    """dx of ``conv3d_p`` is one forward launch with the kernel flipped in
    (z,y,x) and Cin, Cout swapped (sprint64's dx shapes, and ragged ones
    through 16- and 4-byte copies), against the plain conv of the same."""
    from featurenet_tpu_torch.ops import conv3d

    g = torch.Generator(device=cuda).manual_seed(b + cin + cout)
    x = torch.randn((b, 16, 16, 16, cin), device=cuda, generator=g)
    w = torch.randn((3, 3, 3, cin, cout), device=cuda, generator=g) / (27 * cin) ** 0.5
    gy = torch.randn((b, 16, 16, 16, cout), device=cuda, generator=g)
    xr = x.clone().requires_grad_()
    out = conv3d.conv3d_p(xr, w)
    before = conv3d.conv3d_fwd_launches
    out.backward(gy)
    want = conv3d.conv3d_plain(gy, w.flip(0, 1, 2).transpose(3, 4))
    torch.cuda.synchronize()
    assert conv3d.conv3d_fwd_launches == before + 1
    assert float((xr.grad - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("which", ["x", "w"])
def test_conv3d_fwd_takes_inputs_off_16_byte_alignment(cuda, which):
    """A contiguous view at storage offset 1 lies 4 bytes off 16-byte
    alignment: the wrapper plans 4-byte copies for it before the launch, and
    the kernel matches the plain version."""
    from featurenet_tpu_torch.ops import conv3d

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((2, 6, 5, 4, 8), device=cuda, generator=g)
    w = torch.randn((3, 3, 3, 8, 12), device=cuda, generator=g)
    t = x if which == "x" else w
    flat = torch.empty(t.numel() + 1, device=cuda)
    flat[1:] = t.reshape(-1)
    shifted = flat[1:].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    x, w = (shifted, w) if which == "x" else (x, shifted)
    assert conv3d.fwd_plan(x.shape, 12, x.data_ptr(), w.data_ptr()).vec == 1
    before = conv3d.conv3d_fwd_launches
    got = conv3d.conv3d_fwd(x, w)
    want = conv3d.conv3d_plain(x, w)
    torch.cuda.synchronize()
    assert conv3d.conv3d_fwd_launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_conv3d_fwd_entry_refuses_a_launch_it_cannot_run(cuda):
    """The C entry refuses 16-byte copies for a channel count that is not a
    multiple of 4 or a base off 16-byte alignment, an unknown copy width
    and a tile it has no instance of; it returns the error, launches
    nothing, and leaves the output as it was."""
    from featurenet_tpu_torch.ops import conv3d

    fn = conv3d._kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def call(cin, cout, bm, bn, vec, x_off=0):
        x = torch.ones(2 * 4 ** 3 * cin + 4, device=cuda)
        w = torch.ones((3, 3, 3, cin, cout), device=cuda)
        out = torch.full((2, 4, 4, 4, cout), 7.0, device=cuda)
        rc = fn(x.data_ptr() + 4 * x_off, w.data_ptr(), out.data_ptr(),
                2, 4, 4, 4, cin, cout, 3, bm, bn, vec, stream)
        torch.cuda.synchronize()
        return rc, bool((out == 7.0).all())

    assert call(8, 8, 128, 32, 4) == (0, False)  # a launch it can run
    assert call(8, 8, 128, 32, 1, x_off=1) == (0, False)
    for cin, cout, bm, bn, vec, x_off in [
            (6, 8, 128, 32, 4, 0), (8, 6, 128, 32, 4, 0), (8, 8, 128, 32, 4, 1),
            (8, 8, 128, 32, 2, 0), (8, 8, 256, 32, 1, 0), (8, 8, 512, 64, 1, 0)]:
        rc, untouched = call(cin, cout, bm, bn, vec, x_off)
        assert rc != 0 and untouched, (cin, cout, bm, bn, vec, x_off)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from featurenet_tpu_torch.ops import conv3d

    x = torch.zeros((1, 4, 4, 4, 8), device=cuda)
    w = torch.zeros((3, 3, 3, 8, 8), device=cuda)
    with pytest.raises(TypeError):
        conv3d.conv3d_p(x.bfloat16(), w)
    with pytest.raises(ValueError, match="contiguous"):
        conv3d.conv3d_p(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv3d.conv3d_p(x, w.cpu())


def test_predictor_on_card_matches_cpu(cuda):
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime import build_model

    cfg = get_config("smoke16")
    state = build_model(cfg, seed=0).state_dict()
    grids = (np.random.default_rng(0).random((5, 16, 16, 16)) > 0.5)
    _, on_card = Predictor(state, cfg, batch=4, device="cuda").predict_voxels(grids)
    _, on_cpu = Predictor(state, cfg, batch=4, device="cpu").predict_voxels(grids)
    # bf16 activations: a conv output on either side of a bf16 rounding
    # boundary moves a probability by a few 1e-4 at most.
    np.testing.assert_allclose(on_card, on_cpu, atol=2e-3)


DW_SHAPES = [  # b, d, h, w, cin, cout, k
    (1, 5, 6, 7, 3, 5, 3),
    (2, 8, 8, 8, 17, 33, 3),
    (3, 4, 9, 5, 40, 70, 5),
    (1, 6, 6, 6, 16, 32, 1),
    (2, 9, 9, 9, 8, 96, 7),
    (3, 5, 7, 9, 33, 65, 3),  # 945 positions: the last slab is short
    (1, 3, 3, 3, 3, 5, 1),  # 3 x 5 output: inside one m16 x n8 fragment
    (16, 16, 16, 16, 32, 32, 3),
    (16, 16, 16, 16, 64, 64, 3),
    (2, 3, 4, 1, 8, 12, 3),  # W=1: the halo on both sides of one 16-byte copy
    (1, 3, 5, 7, 4, 8, 3),  # 105 positions: the last 16-position chunk is partial
    (3, 5, 7, 9, 32, 64, 3),  # 945 positions through 16-byte copies
]


def _dw_inputs(cuda, b, d, h, w, cin, cout, dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(b * d + cin + cout)
    x = torch.randn((b, d, h, w, cin), device=cuda, generator=g).to(dtype)
    gy = torch.randn((b, d, h, w, cout), device=cuda, generator=g).to(dtype)
    return x, gy


@pytest.mark.parametrize("b,d,h,w,cin,cout,k", DW_SHAPES)
@pytest.mark.parametrize("kernel", ["conv3d_dw", "folded_f32", "folded_bf16"])
def test_dw_kernels_match_plain(cuda, kernel, b, d, h, w, cin, cout, k):
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    dtype = torch.bfloat16 if kernel == "folded_bf16" else torch.float32
    x, gy = _dw_inputs(cuda, b, d, h, w, cin, cout, dtype)
    if kernel == "conv3d_dw":
        before = conv3d.conv3d_dw_launches
        got = conv3d.conv3d_dw(x, gy, k)
        launched = conv3d.conv3d_dw_launches - before
    else:
        before = conv_dw.conv_dw_folded_launches
        got = conv_dw.conv_dw_folded(x, gy, k)
        launched = conv_dw.conv_dw_folded_launches - before
    want = conv_dw.conv_dw_plain(x, gy, k)
    torch.cuda.synchronize()
    assert launched == 1
    assert got.dtype == torch.float32 and got.shape == (k, k, k, cin, cout)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("fn,plain", [("conv3d_p", "conv3d_plain"),
                                       ("conv3d_hybrid", "conv3d_hybrid_plain")])
@pytest.mark.parametrize("cin,cout", [(32, 64), (64, 32)])
def test_conv_autograd_on_card_matches_plain(cuda, fn, plain, cin, cout):
    """dx and dW of the autograd functions through the kernels against
    autograd through the plain versions, fp32."""
    from featurenet_tpu_torch.ops import conv3d

    g = torch.Generator(device=cuda).manual_seed(cin + cout)
    x = torch.randn((8, 16, 16, 16, cin), device=cuda, generator=g)
    w = torch.randn((3, 3, 3, cin, cout), device=cuda, generator=g) / (27 * cin) ** 0.5
    gy = torch.randn((8, 16, 16, 16, cout), device=cuda, generator=g)
    grads = []
    for f in (getattr(conv3d, fn), getattr(conv3d, plain)):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        (f(xr, wr) * gy).sum().backward()
        grads.append((xr.grad, wr.grad))
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("kernel", ["conv3d_dw", "folded_f32", "folded_bf16"])
def test_dw_kernels_are_bitwise_repeatable(cuda, kernel):
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    dtype = torch.bfloat16 if kernel == "folded_bf16" else torch.float32
    fn = conv3d.conv3d_dw if kernel == "conv3d_dw" else conv_dw.conv_dw_folded
    # 32→64 (column tile 64) and sprint64's 32→32 at batch 16 (tile 128).
    for b, cin, cout in ((32, 32, 64), (16, 32, 32)):
        x, gy = _dw_inputs(cuda, b, 16, 16, 16, cin, cout, dtype)
        first = fn(x, gy, 3)
        second = fn(x, gy, 3)
        torch.cuda.synchronize()
        assert torch.equal(first, second), (cin, cout)


@pytest.mark.parametrize("which", ["x", "g"])
def test_conv3d_dw_takes_inputs_off_16_byte_alignment(cuda, which):
    """A contiguous view at storage offset 1 lies 4 bytes off 16-byte
    alignment: the wrapper plans 4-byte copies for it before the launch, and
    the kernel matches the plain version."""
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    x, gy = _dw_inputs(cuda, 2, 6, 5, 4, 8, 12)
    t = x if which == "x" else gy
    flat = torch.empty(t.numel() + 1, device=cuda)
    flat[1:] = t.reshape(-1)
    shifted = flat[1:].view(t.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    x, gy = (shifted, gy) if which == "x" else (x, shifted)
    assert conv3d.dw_plan(x.shape, 12, 3, x.data_ptr(), gy.data_ptr()).vec == 1
    before = conv3d.conv3d_dw_launches
    got = conv3d.conv3d_dw(x, gy, 3)
    want = conv_dw.conv_dw_plain(x, gy, 3)
    torch.cuda.synchronize()
    assert conv3d.conv3d_dw_launches == before + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("kernel", ["conv3d_dw", "conv_dw_folded"])
def test_dw_wrappers_refuse_what_the_kernels_do_not_take(cuda, kernel):
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    fn = conv3d.conv3d_dw if kernel == "conv3d_dw" else conv_dw.conv_dw_folded
    x = torch.zeros((1, 4, 4, 4, 8), device=cuda)
    gy = torch.zeros((1, 4, 4, 4, 8), device=cuda)
    with pytest.raises(TypeError):
        fn(x.half(), gy.half(), 3)
    with pytest.raises(TypeError):
        fn(x.bfloat16(), gy, 3)  # mixed types
    if kernel == "conv3d_dw":
        with pytest.raises(TypeError):
            fn(x.bfloat16(), gy.bfloat16(), 3)  # fp32 only, like the TPU kernel
    with pytest.raises(ValueError, match="contiguous"):
        fn(x.transpose(1, 2), gy, 3)
    with pytest.raises(ValueError):
        fn(x, gy.cpu(), 3)
    with pytest.raises(ValueError):
        fn(x, gy, 2)


def test_smoke16_train_step_on_card_matches_cpu(cuda):
    """Three steps of the smoke16 trainer (bf16 model, dropout off, warmup
    1 so steps 1 and 2 move the weights) from one state on one batch, on
    the card and on the CPU. The two differ where a conv output lands on
    the other side of a bf16 rounding boundary (2^-8 relative); losses
    agree to 1e-2 and gradient norms to 2 %. Adam's early updates are
    near lr·sign(g), so a weight whose gradient is rounding noise may move
    the other way: parameters agree to 2·lr per moving step."""
    import dataclasses

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.dataset import SyntheticVoxelDataset
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("smoke16", global_batch=8, warmup_steps=1)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch, dropout=0.0))
    state = build_model(cfg, seed=0).state_dict()
    batch = {k: torch.from_numpy(v) for k, v in
             next(iter(SyntheticVoxelDataset(16, 8, seed=3))).items()}
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, device=dev, state=state)
        on = {k: v.to(dev) for k, v in batch.items()}
        metrics = [{k: float(v) for k, v in tr.step(on).items()} for _ in range(3)]
        runs[dev] = (metrics, {k: v.cpu() for k, v in
                               tr.state.model.state_dict().items()})
    (m_card, s_card), (m_cpu, s_cpu) = runs["cuda"], runs["cpu"]
    for a, b in zip(m_card, m_cpu):
        assert abs(a["loss"] - b["loss"]) <= 1e-2
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 2e-2 * b["grad_norm"]
    lr = tr.state.optimizer.schedule
    tol = 2 * (lr(1) + lr(2)) + 1e-6
    for k in s_cpu:
        assert float((s_card[k] - s_cpu[k]).abs().max()) <= tol, k


def _card_trainer(cuda, ckpt):
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("smoke16", global_batch=8, warmup_steps=1, eval_batches=1,
                     data_workers=1, checkpoint_dir=str(ckpt))
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in next(tr.train_data.worker_iter(0)).items()}
    return tr, batch


def test_checkpoint_snapshot_is_the_saved_step_while_steps_run(cuda, tmp_path,
                                                               monkeypatch):
    """``save`` returns at once; the next steps rewrite the live tensors in
    place while the writer is still asleep; the step on disk is still the
    one saved, bitwise."""
    import time

    from featurenet_tpu_torch.train import checkpoint

    tr, batch = _card_trainer(cuda, tmp_path / "ck")
    for _ in range(2):
        tr.step(batch)
    want = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    want_mu = [t.clone() for t in tr.state.optimizer.mu]
    to_host = checkpoint.CheckpointManager._to_host

    def late(self, snap, event):
        time.sleep(0.5)
        return to_host(self, snap, event)

    monkeypatch.setattr(checkpoint.CheckpointManager, "_to_host", late)
    tr.ckpt.save(tr.state)
    for _ in range(3):
        tr.step(batch)
    tr.ckpt.wait()
    saved = torch.load(str(tmp_path / "ck" / "step_2.pt"), weights_only=True)
    assert (saved["step"], saved["count"]) == (2, 2)
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v.cpu()), k
    names = [n for n, _ in tr.state.model.named_parameters()]
    for n, v in zip(names, want_mu):
        assert torch.equal(saved["mu"][n], v.cpu()), n
    assert not torch.equal(tr.state.model.dense1.weight, want["dense1.weight"])


def test_restore_onto_the_card_from_a_checkpoint_written_there(cuda, tmp_path):
    """A fresh card trainer resumes the card run's newest step onto the
    card, bitwise, and its next step updates the restored tensors as the
    first run's does (cuDNN set deterministic for the comparison)."""
    tr, batch = _card_trainer(cuda, tmp_path / "ck")
    for _ in range(2):
        tr.step(batch)
        tr.ckpt.save(tr.state)
    tr.ckpt.close()
    again, _ = _card_trainer(cuda, tmp_path / "ck")
    assert again.resume_if_available() == 2
    assert again.state.optimizer.count == 2
    live = {k: v.clone() for k, v in again.state.model.state_dict().items()}
    for k, v in tr.state.model.state_dict().items():
        assert live[k].device.type == "cuda" and torch.equal(live[k], v), k
    for a, b in zip(again.state.optimizer.mu + again.state.optimizer.nu,
                    tr.state.optimizer.mu + tr.state.optimizer.nu):
        assert a.device.type == "cuda" and torch.equal(a, b)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tr.step(batch)
        again.step(batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for k, v in tr.state.model.state_dict().items():
        assert torch.equal(again.state.model.state_dict()[k], v), k
    assert not torch.equal(again.state.model.dense1.weight, live["dense1.weight"])


def test_resident_draw_on_card_equals_host_gather(cuda, tmp_path):
    """A Trainer with ``hbm_cache`` holds the cache's train split on the
    card; rows drawn there and gathered by the resident step's
    ``gather_rows`` are, bitwise, what the dataset gathers on the host for
    the same samples. Its run draws every batch on the card."""
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.offline import export_synthetic_cache
    from featurenet_tpu_torch.train.loop import Trainer
    from featurenet_tpu_torch.train.steps import draw_rows, gather_rows

    cache = str(tmp_path / "c")
    export_synthetic_cache(cache, per_class=4, resolution=16, seed=2)
    cfg = get_config("smoke16", data_cache=cache, hbm_cache=True, global_batch=8,
                     total_steps=2, eval_every=100)
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    assert tr._data.is_cuda and tr._labels.is_cuda
    idx = draw_rows(torch.Generator(device=cuda).manual_seed(1), tr._data.shape[0], 64)
    assert idx.is_cuda
    got = gather_rows(tr._data, tr._labels, idx)
    samples = tr.train_data.resident_order()[idx.cpu().numpy()]
    np.testing.assert_array_equal(got["voxels"].cpu().numpy(),
                                  tr.train_data._gather(samples))
    np.testing.assert_array_equal(got["label"].cpu().numpy(),
                                  tr.train_data.labels[samples])
    assert np.isfinite(tr.run()["loss"]) and tr.state.step == 2


def test_rotation_on_card_equals_cpu(cuda):
    """Each of the 24 cube rotations, and a batch rotated group by group,
    are bitwise the same on the card and on the CPU."""
    from featurenet_tpu_torch.ops.augment import rotate_grids, rotate_groups

    x = (torch.rand((8, 16, 16, 16, 1), generator=torch.Generator().manual_seed(0))
         < 0.4).to(torch.uint8)
    on = x.to(cuda)
    for code in range(24):
        assert torch.equal(rotate_grids(on, code).cpu(), rotate_grids(x, code)), code
    codes = [5, 23, 0, 11]
    assert torch.equal(rotate_groups(on, codes).cpu(), rotate_groups(x, codes))


@pytest.mark.parametrize("backend", ["pallas", "hybrid_dw"])
def test_fp16_overflow_skip_is_bitwise_on_card(cuda, backend):
    """An ``fp16_scaled`` smoke16 step on the card at loss scale 2^30
    overflows and is skipped bitwise (parameters, Adam moments, count,
    batch-norm statistics), the step advances and the scale halves; the
    kernels ran for it. A bf16_master step through the kernels moves the
    masters, which stay fp32."""
    import dataclasses
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.ops import conv3d, conv_dw
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("smoke16", global_batch=8, warmup_steps=1,
                     train_precision="fp16_scaled")
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch,
                                                            conv_backend=backend))
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in next(tr.train_data.worker_iter(0)).items()}
    for _ in range(2):
        tr.step(batch)
    tr.state.loss_scale.fill_(2.0 ** 30)
    opt = tr.state.optimizer
    before = ([v.clone() for v in tr.state.model.state_dict().values()]
              + [t.clone() for t in opt.mu + opt.nu])
    count, step = opt.count, tr.state.step
    fwd, dw = conv3d.conv3d_fwd_launches, conv_dw.conv_dw_folded_launches
    m = tr.step(batch)
    assert float(m["grads_finite"]) == 0.0
    assert (float(tr.state.loss_scale), int(tr.state.good_steps)) == (2.0 ** 29, 0)
    assert (opt.count, tr.state.step) == (count, step + 1)
    after = ([v for v in tr.state.model.state_dict().values()]
             + list(opt.mu + opt.nu))
    for a, b in zip(before, after):
        assert torch.equal(a, b)
    if backend == "pallas":
        # 2 forward, 1 dx: the first block's input (the voxels) needs none.
        assert conv3d.conv3d_fwd_launches == fwd + 3
    else:
        assert conv_dw.conv_dw_folded_launches == dw + 2


def test_int8_predictor_keeps_int8_on_card(cuda):
    """The int8 Predictor's weights sit on the card as int8 (plus fp32
    scales, biases and batch-norm vectors), a quarter of the fp32 bytes
    and then some; its module parameters hold no device memory; it serves
    through the forward kernel."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.ops import conv3d

    cfg = get_config("smoke16")
    full = Predictor.from_seed(cfg, 0, batch=4, device=cuda)
    q = Predictor.from_seed(cfg, 0, batch=4, device=cuda, precision="int8")
    ints = [t for t in q._qparams.values() if t.dtype == torch.int8]
    assert ints and all(t.is_cuda for t in ints)
    assert all(t.is_cuda for t in q._scales.values())
    assert all(p.is_meta for p in q.model.parameters())
    assert q.resident_weight_bytes < 0.3 * full.resident_weight_bytes
    x = np.zeros((4, 16, 16, 16, 1), np.float32)
    x[:, 4:12, 4:12, 4:12] = 1.0
    # The program captures the kernel twice; replays launch nothing more.
    assert q.program_for(4).capture_launches["conv3d_fwd"] == 2
    n = conv3d.conv3d_fwd_launches
    probs = q.forward_padded(x)
    assert conv3d.conv3d_fwd_launches == n and q.replays == 1
    np.testing.assert_allclose(probs, full.forward_padded(x), atol=5e-2)


SERVE_BUCKETS = (1, 4, 16, 64)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_graphed_forward_is_bitwise_the_eager_forward(cuda, precision):
    """sprint64 at full width: every bucket's program is a CUDA graph that
    captured the forward kernel once per 3³ block (3), and its replay gives
    the eager forward's probabilities bitwise on the same input, twice
    (the static buffers are reused); a replay launches no kernel from
    Python."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.ops import conv3d

    cfg = get_config("sprint64")
    pred = Predictor.from_seed(cfg, 0, batch=64, device=cuda, precision=precision)
    g = torch.Generator(device=cuda).manual_seed(1)
    for b in sorted(SERVE_BUCKETS, reverse=True):
        prog = pred.program_for(b)
        assert prog.graph is not None and prog.name == (
            "serve" if precision == "fp32" else f"serve_{precision}")
        assert prog.capture_launches["conv3d_fwd"] == 3, prog.capture_launches
    for b in SERVE_BUCKETS:
        for _ in range(2):
            x = (torch.rand((b, 64, 64, 64, 1), device=cuda, generator=g)
                 > 0.7).float()
            n = conv3d.conv3d_fwd_launches
            got = pred.forward(x)
            assert conv3d.conv3d_fwd_launches == n
            with torch.inference_mode():
                want = pred.forward_eager(x)
            assert torch.equal(got, want), (b, float((got - want).abs().max()))
    assert pred.replays == 2 * len(SERVE_BUCKETS)


def test_each_replay_runs_the_forward_kernel(cuda):
    """Under the profiler, each replay of a captured sprint64 program runs
    exactly 3 ``conv3d_fwd_kernel`` on the card: the hand-written kernel
    launched from its library onto the capturing stream lands in the
    graph. The profiler loses device events at the edges of its window,
    so the 5 counted replays run between uncounted ones, and each is
    matched to its kernels by correlation id."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor

    pred = Predictor.from_seed(get_config("sprint64"), 0, batch=4, device=cuda)
    x = torch.zeros((4, 64, 64, 64, 1), device=cuda)
    pred.forward(x)
    torch.cuda.synchronize()
    lead, counted, tail = 2, 5, 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead + counted + tail):
            pred.forward(x)
        torch.cuda.synchronize()
        time.sleep(0.1)
    events = prof.events()
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name == "cudaGraphLaunch")
    assert len(launches) == lead + counted + tail
    hits = {cid: 0 for _, cid in launches[lead:lead + counted]}
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.id in hits
                and "conv3d_fwd_kernel" in e.name):
            hits[e.id] += 1
    assert list(hits.values()) == [3] * counted, sorted(
        {e.name for e in events if e.device_type == DeviceType.CUDA})


@pytest.mark.parametrize("skip", [False, True])
def test_fp16_scaled_step_makes_no_host_sync(cuda, skip):
    """An ``fp16_scaled`` smoke16 step through the kernels, applied (at a
    healthy scale) and skipped (at 2^30), runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the verdict, the count and
    the schedule stay on the card."""
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("smoke16", global_batch=8, warmup_steps=1,
                     train_precision="fp16_scaled")
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in next(tr.train_data.worker_iter(0)).items()}
    for _ in range(2):
        tr.step(batch)
    tr.state.loss_scale.fill_(2.0 ** 30 if skip else 2.0 ** 10)
    count = tr.state.optimizer.count
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = tr.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(m["grads_finite"]) == (0.0 if skip else 1.0)
    assert int(tr.state.optimizer.count) == int(count) + (0 if skip else 1)
    assert tr.state.step == 3


def _seeded_checkpoint(path, cfg, seed):
    """A one-step checkpoint directory of ``cfg``'s model from ``seed``."""
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    state = create_state(build_model(cfg, seed=seed), cfg)
    state.step = 1
    mgr = CheckpointManager(str(path), config=cfg)
    mgr.save(state)
    mgr.close()
    return str(path)


def test_swap_under_replay_keeps_the_old_answers_until_the_flip(cuda, tmp_path):
    """While a thread replays bucket 16 and reads each answer back, the
    main thread swaps to another checkpoint (restore, then captures on the
    new generation's own stream and pool). Every answer is bitwise the old
    or the new generation's eager forward: the old one's until the swap
    starts, the new one's once it has returned."""
    import threading
    import time

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor

    cfg = get_config("sprint64")
    a = _seeded_checkpoint(tmp_path / "a", cfg, 0)
    b = _seeded_checkpoint(tmp_path / "b", cfg, 1)
    pred = Predictor.from_checkpoint(a, batch=16, device=cuda)
    for bucket in (16, 1):
        pred.program_for(bucket)
    x = (torch.rand((16, 64, 64, 64, 1), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2)) > 0.7).float()
    with torch.inference_mode():
        old = pred.forward_eager(x).cpu()
    answers, stop, errors = [], threading.Event(), []

    def replay():
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                out = pred.forward(x).cpu()
                answers.append((t0, time.perf_counter(), out))
        except Exception as e:  # surfaced below
            errors.append(e)

    th = threading.Thread(target=replay)
    th.start()
    time.sleep(0.2)
    t_swap = time.perf_counter()
    version = pred.swap_params(b)
    t_flip = time.perf_counter()
    time.sleep(0.2)
    stop.set()
    th.join(60)
    assert not errors, errors
    assert version == pred.model_version and version.startswith("b@1-")
    assert pred.program_for(1).graph is not None
    with torch.inference_mode():
        new = pred.forward_eager(x).cpu()
    assert not torch.equal(old, new)
    before = [o for t0, t1, o in answers if t1 < t_swap]
    after = [o for t0, t1, o in answers if t0 > t_flip]
    assert before and after
    assert all(torch.equal(o, old) for o in before)
    assert all(torch.equal(o, new) for o in after)
    assert all(torch.equal(o, old) or torch.equal(o, new) for _, _, o in answers)


def test_augment_on_card_equals_cpu(cuda):
    """The affine warp (and its plain gather) of the same voxels and draws
    on the card and on the CPU, within 1e-5 (the same fp32 coordinates,
    another order of the trilinear sum in grid_sample's kernel); the noise flips
    exactly the mask it is given; device cube codes rotate bitwise as the
    CPU's permute and flip."""
    from featurenet_tpu_torch.ops import augment

    g = torch.Generator().manual_seed(0)
    x = (torch.rand((16, 16, 16, 16, 1), generator=g) < 0.4).float()
    draw = augment.draw_affine(g, 16, 8, prob=0.5, translate_vox=1.5)
    assert bool(draw.take.any()) and not bool(draw.take.all())
    want = augment.affine_warp(x, *draw)
    on = [t.to(cuda) for t in draw]
    got = augment.affine_warp(x.to(cuda), *on).cpu()
    plain = augment.affine_warp_plain(x.to(cuda), *on).cpu()
    assert float((got - want).abs().max()) <= 1e-5
    assert float((plain - want).abs().max()) <= 1e-5
    kept = ~draw.take.repeat_interleave(2)
    assert torch.equal(got[kept], x[kept])
    flips = augment.draw_flips(g, tuple(x.shape), 0.05)
    noisy = augment.occupancy_noise(got.to(cuda), flips.to(cuda)).cpu()
    assert torch.equal(noisy, (got - flips.float()).abs())
    codes = torch.tensor([5, 23, 0, 11])
    bits = x.to(torch.uint8)
    assert torch.equal(augment.rotate_by_codes(bits.to(cuda), codes.to(cuda)).cpu(),
                       augment.rotate_groups(bits, codes.tolist()))


@pytest.mark.parametrize("resident", [True, False])
def test_k_step_graph_replay_equals_eager_steps(cuda, tmp_path, resident):
    """smoke16 under the robust recipe (affine warp at prob 0.5, noise,
    dropout 0.2) from a cache at k = 8: two dispatches replay one captured
    CUDA graph, and land where 16 eager steps from the same state land
    (rtol 1e-6, atol 1e-7, the reference's k-step tolerance), the graph
    holding 8 steps' kernel launches and a replay launching none from
    Python. An eager step of the recipe makes no host synchronisation."""
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.offline import export_synthetic_cache
    from featurenet_tpu_torch.ops import launch_counts
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.loop import Trainer

    cache = str(tmp_path / "c")
    export_synthetic_cache(cache, per_class=4, resolution=16, seed=2)
    cfg = get_config("smoke16", data_cache=cache, hbm_cache=resident,
                     global_batch=16, steps_per_dispatch=8, warmup_steps=2,
                     augment_affine=True, augment_affine_prob=0.5,
                     augment_noise=0.005)
    weights = build_model(cfg, seed=0).state_dict()
    graphed = Trainer(cfg, device=cuda, state=weights, stream=io.StringIO())
    eager = Trainer(cfg, device=cuda, state=weights, stream=io.StringIO())
    it = graphed.train_data.worker_iter(0)
    batches = [] if resident else [
        {k: torch.from_numpy(v).to(cuda) for k, v in next(it).items()}
        for _ in range(16)]
    before = launch_counts()
    eager.step(batches[0] if batches else None)
    per_step = {k: v - before[k] for k, v in launch_counts().items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.step(batches[1] if batches else None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for i in range(2, 16):
        eager.step(batches[i] if batches else None)
    graphed.dispatch(batches[:8] or None, 8)
    before = launch_counts()
    metrics = graphed.dispatch(batches[8:] or None, 8)
    torch.cuda.synchronize()
    assert launch_counts() == before
    (prog,) = graphed.programs.values()
    assert prog.capture_launches == {k: 8 * v for k, v in per_step.items()}
    assert graphed.state.step == eager.state.step == 16
    assert np.isfinite(float(metrics["loss"]))
    a, b = graphed.state, eager.state
    assert int(a.optimizer.count) == int(b.optimizer.count) == 16
    for x, y in zip(a.tensors(), b.tensors()):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)
    assert not torch.equal(a.model.dense1.weight.cpu(), weights["dense1.weight"])


def test_pacing_waits_for_its_event_not_the_stream(cuda):
    """``DispatchPacer`` waits for the dispatch ``depth`` marks back alone:
    with a long kernel enqueued after it, the wait returns while that
    kernel still runs (a readback would have waited for it)."""
    import time

    from featurenet_tpu_torch.train.loop import DispatchPacer

    pacer = DispatchPacer(cuda)
    x = torch.ones(1 << 20, device=cuda)
    x.mul_(2)
    assert not pacer.mark(1)
    torch.cuda._sleep(1 << 31)  # ~1 s of one thread spinning on the card
    end = torch.cuda.Event()
    end.record()
    t0 = time.perf_counter()
    assert pacer.mark(1)
    waited = time.perf_counter() - t0
    still_running = not end.query()
    torch.cuda.synchronize()
    assert still_running and waited < 0.1


def test_sigterm_during_a_k8_replay_exits_75_at_the_boundary(cuda, tmp_path):
    """smoke16 under the robust recipe, resident, k = 8, with
    ``sigterm@step=1``: the signal lands while the first group's graph
    replays; the run saves step 8 and exits 75, holding (and having saved)
    the state of 8 eager steps from the same weights, bitwise."""
    import dataclasses
    import io
    import json
    import os

    from featurenet_tpu_torch import faults
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.offline import export_synthetic_cache
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.loop import Trainer

    cache = str(tmp_path / "c")
    export_synthetic_cache(cache, per_class=4, resolution=16, seed=2)
    ck = str(tmp_path / "ck")
    cfg = get_config("smoke16", data_cache=cache, hbm_cache=True,
                     global_batch=16, steps_per_dispatch=8, warmup_steps=2,
                     total_steps=24, augment_affine=True, augment_affine_prob=0.5,
                     augment_noise=0.005, checkpoint_dir=ck,
                     checkpoint_every=100, inject_faults="sigterm@step=1")
    weights = build_model(cfg, seed=0).state_dict()
    out = io.StringIO()
    graphed = Trainer(cfg, device=cuda, state=weights, stream=out)
    try:
        with pytest.raises(SystemExit) as e:
            graphed.run()
    finally:
        faults.uninstall()
    assert e.value.code == 75 and graphed.state.step == 8
    assert graphed.ckpt.all_steps() == [8]
    assert json.loads(out.getvalue().splitlines()[-1]) == {
        "step": 8, "kind": "setup", "preempt_exit": 1.0}
    eager = Trainer(dataclasses.replace(cfg, checkpoint_dir=None, inject_faults=None),
                    device=cuda, state=weights, stream=io.StringIO())
    for _ in range(8):
        eager.step()
    restored = Trainer(dataclasses.replace(cfg, inject_faults=None), device=cuda,
                       stream=io.StringIO())
    assert restored.resume_if_available() == 8
    for x, y, z in zip(graphed.state.tensors(), eager.state.tensors(),
                       restored.state.tensors()):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert os.path.exists(os.path.join(ck, "fault_sigterm.fired"))



def test_tta_through_the_kernels_matches_the_plain_conv(cuda):
    """sprint64 at full width, bucket 64: ``predict_voxels(tta_rotations=
    True)`` over 40 parts (960 rows, 15 replays of the bucket-64 graph)
    against the mean of the plain conv's probabilities over the 24
    rotations (the serving agreement bar, 2e-3); a cube rotation of the
    input moves the vote by fp32 rounding only; the device peak of the vote
    stays far below 24 rotated copies of the parts."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.ops.augment import CUBE_GROUP, apply_rotation
    from featurenet_tpu_torch.runtime import build_model, serve_forward

    cfg = get_config("sprint64")
    pred = Predictor.from_seed(cfg, 0, batch=64, device=cuda)
    grids = generate_batch(np.random.default_rng(2), 40, 64)["voxels"][..., 0]
    pred.program_for(64)
    replays = pred.replays
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    labels, probs = pred.predict_voxels(grids, tta_rotations=True)
    peak = torch.cuda.max_memory_allocated() - base
    assert pred.replays - replays == 15
    assert peak < 6 * grids[:1].nbytes * 64, peak  # 24 copies: 24 x 40 parts
    plain = build_model(cfg, seed=0, plain=True).to(cuda)
    x = torch.from_numpy(grids[..., None]).to(cuda)
    with torch.inference_mode():
        want = sum(serve_forward(plain, apply_rotation(x, p, f).contiguous())
                   for p, f in CUBE_GROUP) / len(CUBE_GROUP)
    np.testing.assert_allclose(probs, want.cpu().numpy(), rtol=0, atol=2e-3)
    perm, flips = CUBE_GROUP[9]
    turned = np.transpose(grids, (0, *(1 + p for p in perm)))
    turned = np.flip(turned, [1 + i for i, f in enumerate(flips) if f])
    _, again = pred.predict_voxels(np.ascontiguousarray(turned),
                                   tta_rotations=True)
    np.testing.assert_allclose(again, probs, rtol=0, atol=1e-5)
    assert labels.shape == (40,)


def test_native_voxelizer_on_the_card_host_is_bitwise_numpy(cuda):
    """The native library builds (g++, into build/native/) on the card's
    host and its parity fill is bitwise the numpy fill on 64³ parts, one of
    them rotated off the grid axes."""
    from featurenet_tpu_torch import native
    from featurenet_tpu_torch.data.synthetic import generate_sample
    from featurenet_tpu_torch.data.voxel_to_mesh import (
        random_rotation_matrix,
        rotate_mesh,
        voxels_to_mesh,
    )
    from featurenet_tpu_torch.data.voxelize import voxelize

    assert native.build()["path"].endswith(".so") and native.available()
    rng = np.random.default_rng(4)
    for i, label in enumerate((1, 11)):
        tris = voxels_to_mesh(generate_sample(rng, 64, label=label)[0])
        if i:
            tris = rotate_mesh(tris, random_rotation_matrix(rng))
        np.testing.assert_array_equal(
            voxelize(tris, 64, backend="native"),
            voxelize(tris, 64, backend="numpy"))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_segmenter_graphed_labels_are_bitwise_eager(cuda, precision):
    """seg64 at full width: each bucket's program is a CUDA graph whose
    replay gives the eager forward's int8 labels bitwise, twice (the static
    buffers are reused); the segmenter captures no kernel of the package
    (its convolutions are cuDNN's)."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor

    pred = Predictor.from_seed(get_config("seg64"), 0, batch=4, device=cuda,
                               precision=precision)
    for b in (4, 1):
        prog = pred.program_for(b)
        assert prog.graph is not None and not any(prog.capture_launches.values())
    g = torch.Generator(device=cuda).manual_seed(1)
    for b in (1, 4):
        for _ in range(2):
            x = (torch.rand((b, 64, 64, 64, 1), device=cuda, generator=g)
                 > 0.6).float()
            got = pred.forward(x)
            with torch.inference_mode():
                want = pred.forward_eager(x)
            assert got.dtype == torch.int8 and tuple(got.shape) == (b, 64, 64, 64)
            assert torch.equal(got, want), (b, int((got != want).sum()))
    assert pred.replays == 4


def test_segment_train_steps_on_card(cuda, tmp_path):
    """seg64 at full width and batch 4, resident with the paired rotation:
    an eager step makes no host synchronisation and has a finite loss;
    then k = 2 steps per dispatch replay one captured CUDA graph, every
    loss finite, the parameters moved."""
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.offline import export_seg_cache
    from featurenet_tpu_torch.train.loop import Trainer

    cache = str(tmp_path / "seg")
    export_seg_cache(cache, num_parts=10, resolution=64, seed=1)
    cfg = get_config("seg64", data_cache=cache, hbm_cache=True, global_batch=4,
                     steps_per_dispatch=2, log_every=1, eval_every=10 ** 6)
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    assert tr._labels.is_cuda and tr._labels.dtype == torch.int8
    before = tr.state.model.head.kernel.detach().clone()
    tr.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = tr.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))
    tr.run(num_steps=6)
    assert [k[:2] for k in tr.programs] == [("resident", 2)]
    losses = [r["loss"] for r in tr.logger.history if r["kind"] == "train"]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
    assert not torch.equal(tr.state.model.head.kernel, before)


@pytest.mark.parametrize("data,translate", [("parts", 0.0), ("dense", 1.0)])
def test_paired_warp_on_card_labels_bitwise_plain(cuda, data, translate):
    """seg64's paired affine warp at batch 32 on the card: the warp path's
    labels bitwise its plain gather's and the CPU's; every warped label 0
    or one its sample held; untaken groups bitwise. Its voxels within
    1e-5 of the plain gather and the CPU, on seg64's parts under
    robust64's settings (no translation) and on dense random grids with a
    translation of up to a voxel, where every neighbouring difference is
    up to 1: grid_sample runs in float64, so its normalisation of each
    fp32 source coordinate (up to ~65 here) to [-1, 1] and back keeps the
    coordinate, and the corner weights are its own (in fp32 dense grids
    read 1.23-1.37e-5)."""
    from featurenet_tpu_torch.data.offline import _generate_seg_sample
    from featurenet_tpu_torch.ops import augment

    g = torch.Generator().manual_seed(2)
    if data == "parts":
        rng = np.random.default_rng(2)
        pairs = [_generate_seg_sample(rng, 64, 3, "canonical") for _ in range(32)]
        x = torch.from_numpy(np.stack([p for p, _ in pairs])[..., None]).float()
        seg = torch.from_numpy(np.stack([s for _, s in pairs])).to(torch.int8)
    else:
        x = (torch.rand((32, 64, 64, 64, 1), generator=g) < 0.4).float()
        seg = torch.randint(0, 25, (32, 64, 64, 64), generator=g).to(torch.int8)
        seg[:16] = seg[:16] % 4  # samples that hold few labels
    draw = augment.draw_affine(g, 32, 8, prob=0.5, translate_vox=translate)
    assert bool(draw.take.any()) and not bool(draw.take.all())
    on = [t.to(cuda) for t in draw]
    xv, xs = x.to(cuda), seg.to(cuda)
    got_v, got_s = augment.affine_warp_pair(xv, xs, *on)
    plain_v, plain_s = augment.affine_warp_pair_plain(xv, xs, *on)
    cpu_v, cpu_s = augment.affine_warp_pair(x, seg, *draw)
    assert torch.equal(got_s, plain_s)
    assert torch.equal(got_s.cpu(), cpu_s)
    err = (float((got_v - plain_v).abs().max()),
           float((got_v.cpu() - cpu_v).abs().max()))
    print(f"paired warp, {data}, translate {translate}: voxels {err} from "
          "the plain gather and the CPU")
    assert max(err) <= 1e-5
    for b in range(32):
        held = set(seg[b].unique().tolist()) | {0}
        assert set(got_s[b].unique().tolist()) <= held, b
    kept = (~draw.take).repeat_interleave(4)
    assert torch.equal(got_s.cpu()[kept], seg[kept])
    assert torch.equal(got_v.cpu()[kept], x[kept])


def test_segment_affine_train_steps_on_card(cuda, tmp_path):
    """seg64 at full width and batch 4, resident with the paired affine
    warp in the step: k = 2 steps per dispatch replay one captured CUDA
    graph, every loss finite, and the step makes no host synchronisation."""
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.offline import export_seg_cache
    from featurenet_tpu_torch.train.loop import Trainer

    cache = str(tmp_path / "seg")
    export_seg_cache(cache, num_parts=10, resolution=64, seed=1)
    cfg = get_config("seg64", data_cache=cache, hbm_cache=True, global_batch=4,
                     steps_per_dispatch=2, log_every=1, eval_every=10 ** 6,
                     augment_affine=True, augment_affine_prob=0.5)
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    assert "affine" in tr._draws.streams
    tr.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = tr.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))
    tr.run(num_steps=6)
    assert [k[:2] for k in tr.programs] == [("resident", 2)]
    losses = [r["loss"] for r in tr.logger.history if r["kind"] == "train"]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_serve_packed_graphed_is_bitwise_eager(cuda, precision):
    """sprint64 at full width: the packed program at batches 16 and 1 is a
    CUDA graph that captured the forward kernel once per 3³ block; its
    int32 labels are bitwise its eager body's and the argmax of the same
    precision's serve program on the unpacked grids."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch, pack_voxels
    from featurenet_tpu_torch.infer import Predictor

    cfg = get_config("sprint64")
    pred = Predictor.from_seed(cfg, 0, batch=16, device=cuda, precision=precision)
    grids = generate_batch(np.random.default_rng(2), 16, 64)["voxels"]
    for b in (16, 1):
        prog = pred.packed_program_for(b)
        assert prog.graph is not None and prog.name == (
            "serve_packed" if precision == "fp32" else f"serve_packed_{precision}")
        assert prog.capture_launches["conv3d_fwd"] == 3, prog.capture_launches
        packed = torch.from_numpy(pack_voxels(grids[:b]))
        got = prog(packed)
        assert got.dtype == torch.int32 and got.shape == (b,)
        with torch.inference_mode():
            eager = pred._weights.packed.body(packed.to(cuda))
        assert torch.equal(got, eager)
        probs = pred.forward(torch.from_numpy(grids[:b]).to(cuda))
        assert torch.equal(got, probs.argmax(-1).to(torch.int32))


def test_serve_packed_replay_runs_the_forward_kernel(cuda):
    """Under the profiler each replay of the packed program runs exactly 3
    ``conv3d_fwd_kernel`` on the card (counted replays between uncounted
    ones, matched by correlation id)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor

    pred = Predictor.from_seed(get_config("sprint64"), 0, batch=4, device=cuda)
    prog = pred.packed_program_for(4)
    x = torch.zeros((4, 64, 64, 8), dtype=torch.uint8, device=cuda)
    prog(x)
    torch.cuda.synchronize()
    lead, counted, tail = 2, 5, 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead + counted + tail):
            prog(x)
        torch.cuda.synchronize()
        time.sleep(0.1)
    events = prof.events()
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name == "cudaGraphLaunch")
    assert len(launches) == lead + counted + tail
    hits = {cid: 0 for _, cid in launches[lead:lead + counted]}
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.id in hits
                and "conv3d_fwd_kernel" in e.name):
            hits[e.id] += 1
    assert list(hits.values()) == [3] * counted


def test_stream_and_metrics_round_trip_on_card(cuda):
    """sprint64 served from its graphs: 12 frames over one
    POST /predict_voxels_stream answer the Predictor's labels in frame
    order with ``<stream>.<i>`` trace ids, and GET /metrics counts them."""
    import threading

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.http import make_server
    from featurenet_tpu_torch.serve.loadgen import stream_load
    from featurenet_tpu_torch.serve.service import InferenceService

    cfg = get_config("sprint64")
    grids = generate_batch(np.random.default_rng(4), 12, 64)["voxels"]
    want, _ = Predictor.from_seed(cfg, 0, batch=4, device=cuda).predict_voxels(grids)
    service = InferenceService(Predictor.from_seed(cfg, 0, batch=4, device=cuda),
                               buckets=(1, 4))
    srv = make_server(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        out = stream_load("127.0.0.1", port, grids, trace_id="cardstream")
        import urllib.request

        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
        service.drain()
    assert out["status"] == 200 and out["answered"] == 12, out
    assert [ln["frame"] for ln in out["lines"]] == list(range(12))
    assert [ln["trace"] for ln in out["lines"]] == [f"cardstream.{i}" for i in range(12)]
    assert [ln["label"] for ln in out["lines"]] == want.tolist()
    assert 'featurenet_requests_total{outcome="served"} 12' in metrics
    assert 'featurenet_serving_ms{q="0.99"}' in metrics


def _report_trainer(cuda, tmp_path, **kw):
    """A smoke16 pallas Trainer on the card with a run directory, run for 6
    steps; returns it."""
    import dataclasses
    import os

    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("smoke16", total_steps=6, log_every=3, eval_every=6,
                     data_workers=1, run_dir=str(tmp_path / "run"), **kw)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend="pallas"))
    try:
        with open(os.devnull, "w") as sink:
            trainer = Trainer(cfg, device=cuda, stream=sink)
            trainer.run()
    finally:
        obs.close_run()
    return trainer


def test_report_of_a_trainer_run_on_card(cuda, tmp_path):
    """smoke16 under pallas on the card with a run directory, 2 steps in
    flight: the report has 6 steps, every loop category, readback spans
    only for the paced waits and the metrics reads, and no validation
    finding."""
    from featurenet_tpu_torch.obs import report

    _report_trainer(cuda, tmp_path, max_inflight_steps=2)
    ev, bad = report.load_events(str(tmp_path / "run"))
    assert report.validate_events(ev, bad) == []
    rep = report.build_report(ev, report.load_manifest(str(tmp_path / "run")), bad)
    assert rep["loop"]["steps"] == 6 and rep["run"]["device_count"] >= 1
    paced = [e for e in ev if e.get("name") == "readback" and "src" not in e]
    assert [e["step"] for e in paced] == [3, 4, 5, 6]  # depth 2: from step 3
    assert rep["breakdown"]["dispatch"]["seconds"] > 0


def test_report_profile_window_holds_the_kernels_on_card(cuda, tmp_path):
    """The trace window (steps 2-4) holds the device events of the pallas
    step: for the middle step (the profiler may lose events at its edges)
    one conv3d_fwd_kernel per forward launch and one conv3d_dw_partial per
    weight-gradient launch that an eager step counts."""
    import json
    import os

    from featurenet_tpu_torch.data.dataset import SyntheticVoxelDataset
    from featurenet_tpu_torch.ops import launch_counts

    trainer = _report_trainer(cuda, tmp_path, profile_dir=str(tmp_path / "prof"),
                              profile_start=2, profile_steps=3)
    batch = next(SyntheticVoxelDataset(16, 32).worker_iter(0))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    before = launch_counts()
    trainer.step(batch)
    step = {k: v - before[k] for k, v in launch_counts().items()}
    assert step["conv3d_fwd"] > 0 and step["conv3d_dw"] > 0
    (name,) = os.listdir(tmp_path / "prof")
    assert name.startswith("trace_steps_2-5_")
    with open(tmp_path / "prof" / name) as fh:
        evs = json.load(fh)["traceEvents"]
    ranges = {int(e["name"].split("@")[1]): (e["ts"], e["ts"] + e["dur"])
              for e in evs if e.get("cat") == "user_annotation"
              and e["name"].startswith("train_dispatch@")}
    assert sorted(ranges) == [2, 3, 4]
    t0, t1 = ranges[3]
    corr = {e["args"]["correlation"] for e in evs
            if e.get("cat") == "cuda_runtime" and t0 <= e["ts"] <= t1}
    names = [e["name"] for e in evs
             if e.get("cat") == "kernel" and e["args"].get("correlation") in corr]
    assert sum("conv3d_fwd_kernel" in n for n in names) == step["conv3d_fwd"]
    assert sum("conv3d_dw_partial" in n for n in names) == step["conv3d_dw"]


def test_perf_peak_row_matches_the_card(cuda):
    """The peak table's one row is keyed by the card's own name: on the
    H100 the card reads the known tier, its bf16 peak and bandwidth."""
    from featurenet_tpu_torch.obs import perf

    peaks = perf.local_device_peaks(cuda)
    assert peaks["device_kind"] == torch.cuda.get_device_name(cuda)
    assert peaks["device_kind"] == perf.H100
    assert peaks["tier"] == "known"
    assert peaks["peak_flops"] == 989.4e12 and peaks["peak_bytes_per_sec"] == 3.35e12


def test_perf_graph_program_cost_has_flops_and_peak_bytes(cuda, tmp_path):
    """A serving graph's program_cost: the card's name, the precision, the
    analytic forward FLOPs × batch and the peak rise of its capture; the
    memory poller answers for the card it holds memory on."""
    import json

    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.obs import perf
    from featurenet_tpu_torch.ops.flops import classifier_forward_flops

    cfg = get_config("smoke16")
    obs.init_run(str(tmp_path / "run"), process_index=0)
    try:
        prog = Predictor.from_seed(cfg, 0, batch=4, device=cuda).program_for(4)
        rows = perf.sample_device_memory()
    finally:
        obs.close_run()
    with open(tmp_path / "run" / "events.jsonl") as fh:
        (ev,) = [e for e in map(json.loads, fh) if e["ev"] == "program_cost"]
    assert ev["program"] == "serve" and ev["batch"] == 4
    assert ev["device_kind"] == torch.cuda.get_device_name(cuda)
    assert ev["precision"] == "fp32"
    assert ev["flops"] == classifier_forward_flops(cfg.arch, 16) * 4
    assert isinstance(ev["peak_bytes"], int) and ev["peak_bytes"] >= 0
    assert prog.cost == {"flops": ev["flops"], "peak_bytes": ev["peak_bytes"]}
    assert rows and all(0 < r["bytes_in_use"] <= r["peak_bytes_in_use"]
                        <= r["bytes_limit"] for r in rows)


def test_perf_train_program_peak_bytes_is_the_process_peak(cuda, tmp_path):
    """A k = 2 train graph's program_cost reads the process's peak after
    its capture, as the eager step does: memory held before the Trainer
    was built (a 256 MiB block here) is inside it, not left out."""
    import dataclasses
    import io

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.ops.flops import train_step_flops_per_sample
    from featurenet_tpu_torch.train.loop import Trainer

    held = torch.empty(256 * 2**20, dtype=torch.uint8, device=cuda)
    cfg = get_config("smoke16", total_steps=4, steps_per_dispatch=2,
                     log_every=2, eval_every=10 ** 6, data_workers=1)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend="pallas"))
    tr = Trainer(cfg, device=cuda, stream=io.StringIO())
    tr.run()
    (prog,) = tr.programs.values()
    assert prog.name == "multi_train_step"
    assert prog.cost["flops"] == 2 * cfg.global_batch * \
        train_step_flops_per_sample(cfg.arch, cfg.resolution)
    assert held.numel() < prog.cost["peak_bytes"] <= \
        torch.cuda.max_memory_allocated(cuda)
    del held


def test_perf_trainer_run_folds_mfu_and_device_memory(cuda, tmp_path):
    """A Trainer's run on the card (2 steps in flight, the memory poller
    on): the report's perf section holds train_step with its FLOPs and
    the process's peak, an mfu window of the paced steps with its p50 in
    (0, 1), the device_memory watermark within the card, and the gate
    values read both perf keys."""
    from featurenet_tpu_torch.obs import gates, report

    _report_trainer(cuda, tmp_path, max_inflight_steps=2,
                    poll_device_memory=True)
    ev, bad = report.load_events(str(tmp_path / "run"))
    assert report.validate_events(ev, bad) == []
    rep = report.build_report(ev, None, bad)
    pf = rep["perf"]
    row = pf["programs"]["train_step"]
    assert row["flops"] > 0 and row["peak_bytes"] > 0
    assert pf["device_kind"] == torch.cuda.get_device_name(cuda)
    assert pf["tier"] == "known"
    assert pf["mfu"]["n"] == 4 and 0 < pf["mfu"]["p50"] < 1
    (mem,) = pf["device_memory"].values()
    assert 0 < mem["watermark_bytes"] <= mem["bytes_limit"]
    vals = gates.report_gate_values(rep)
    assert vals["mfu"] == pf["mfu"]["p50"]
    assert vals["hbm_peak_train_bytes"] == row["peak_bytes"]


def _incident_service(cuda, pred, run_dir=None, rules=()):
    """sprint64's buckets, healthy traffic never sampled
    (``trace_sample`` 0): a kept trace is forced."""
    from featurenet_tpu_torch.serve.service import InferenceService

    service = InferenceService(pred, buckets=(1, 4, 16, 64), max_wait_ms=2,
                               queue_limit=256, rules=rules, run_dir=run_dir,
                               slo_p99_ms=float("inf"))
    service.batcher.trace_sample = 0.0
    return service


def _burst(service, grids) -> list:
    """Every grid submitted at once (the batcher fills bucket 64); each
    request's latency in ms."""
    futs = [service.submit_voxels(g) for g in grids]
    for f in futs:
        f.result(timeout=120)
    return [f.latency_ms for f in futs]


def _one_by_one(service, grids) -> list:
    """One request at a time (bucket 1); the answers' rows and latencies."""
    rows, ms = [], []
    for g in grids:
        f = service.submit_voxels(g)
        rows.append(f.result(timeout=120))
        ms.append(f.latency_ms)
    return rows, ms


def test_incident_opens_on_a_burst_and_closes_on_recovery_on_card(cuda,
                                                                 tmp_path):
    """sprint64 on its graphs: the SLO sits between the sequential bucket-1
    latency and a 128-request burst's, both measured here. With a run
    directory the service arms the manager; the burst's window cycle fires
    serving_p99_ms and opens one incident (incidents_open 1, every request
    kept), the bundle holds every piece, a sequential recovery resolves it
    (incidents_open 0)."""
    import os

    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.obs import alerts, incidents, tracing, windows
    from featurenet_tpu_torch.serve.metrics import render_metrics

    grids = generate_batch(np.random.default_rng(6), 128, 64)["voxels"]
    pred = Predictor.from_seed(get_config("sprint64"), 0, batch=64, device=cuda)
    calib = _incident_service(cuda, pred)
    _burst(calib, grids)  # warm
    seq_ms = max(_one_by_one(calib, grids[:32])[1])
    burst_ms = float(np.median(_burst(calib, grids)))
    calib.drain()
    assert seq_ms < burst_ms, (seq_ms, burst_ms)
    slo = (seq_ms * burst_ms) ** 0.5
    run_dir = str(tmp_path / "run")
    obs.init_run(run_dir, process_index=0)
    rule = alerts.AlertRule("serving_p99_ms", ">", slo, "critical")
    service = _incident_service(cuda, pred, run_dir, rules=[rule])

    def gauge():
        (line,) = [ln for ln in render_metrics(service).splitlines()
                   if ln.startswith("featurenet_incidents_open ")]
        return line

    try:
        assert gauge() == "featurenet_incidents_open 0"
        _burst(service, grids)
        windows.flush()  # the emission cycle the 5 s cadence would run
        mgr = incidents.manager()
        assert mgr.open_count() == 1 and tracing.force_all()
        assert gauge() == "featurenet_incidents_open 1"
        (inc_id,) = mgr.open_ids()
        for th in list(mgr._threads):
            th.join(timeout=30)
        _one_by_one(service, grids)  # 128 fast samples fill the window
        windows.flush()
        assert gauge() == "featurenet_incidents_open 0"
        assert not tracing.force_all()
    finally:
        st = service.drain()
        obs.close_run()
        windows.uninstall()
    assert st["incidents"]["opened_total"] == 1
    b = incidents.load_bundle(run_dir, inc_id)
    assert b["missing"] == []
    assert set(incidents.BUNDLE_FILES) <= set(b["manifest"]["files"])
    assert b["manifest"]["state"] == "closed"
    assert "serve-batcher" in b["stacks"] or any(
        s.startswith("serve-batcher;") for s in b["stacks"])
    assert os.path.isdir(os.path.join(run_dir, "incidents", inc_id))


def test_incident_armed_service_answers_bitwise_the_dark_one_on_card(
        cuda, tmp_path):
    """The same grids one at a time through a service with no run
    directory and one armed with an incident open (every request traced):
    the probability rows are bitwise equal."""
    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.obs import alerts, incidents, tracing, windows

    grids = generate_batch(np.random.default_rng(7), 24, 64)["voxels"]
    pred = Predictor.from_seed(get_config("sprint64"), 0, batch=64, device=cuda)
    dark = _incident_service(cuda, pred)
    want = _one_by_one(dark, grids)[0]
    dark.drain()
    run_dir = str(tmp_path / "run")
    obs.init_run(run_dir, process_index=0)
    armed = _incident_service(cuda, pred, run_dir)
    try:
        alerts.fire(alerts.AlertRule("serving_p99_ms", ">", 1.0, "critical"),
                    2.0, 1)
        assert incidents.open_count() == 1 and tracing.force_all()
        got = _one_by_one(armed, grids)[0]
    finally:
        armed.drain()
        obs.close_run()
        windows.uninstall()
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with open(f"{run_dir}/events.jsonl") as fh:
        done = [ln for ln in fh if '"request_done"' in ln]
    assert len(done) == len(grids)  # force-all kept every request
    assert all('"forced": true' in ln for ln in done)


# pod64's stride-1 blocks as one rank of the data-parallel step runs them
# (128 rows): (grid, cin, cout, k).
POD64_RANK_BLOCKS = [(32, 32, 32, 5), (16, 32, 64, 3), (16, 64, 64, 3)]


@pytest.mark.parametrize("r,cin,cout,k", POD64_RANK_BLOCKS)
def test_pod64_rank_shapes_match_plain(cuda, r, cin, cout, k):
    """conv3d_p's forward and dx and conv3d_dw at one pod64 rank's shapes
    (batch 128: 4.2 M positions at conv2's 32³ grid, 537 M floats in its
    activation) against the plain versions."""
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    g = torch.Generator(device=cuda).manual_seed(r + cin + cout + k)
    x = torch.randn((128, r, r, r, cin), device=cuda, generator=g)
    w = torch.randn((k, k, k, cin, cout), device=cuda, generator=g)
    w /= (k ** 3 * cin) ** 0.5
    gy = torch.randn((128, r, r, r, cout), device=cuda, generator=g)
    wd = w.flip(0, 1, 2).transpose(3, 4).contiguous()  # dx's kernel
    for got, want in (
            (lambda: conv3d.conv3d_p(x, w), lambda: conv3d.conv3d_plain(x, w)),
            (lambda: conv3d.conv3d_fwd(gy, wd), lambda: conv3d.conv3d_plain(gy, wd)),
            (lambda: conv3d.conv3d_dw(x, gy, k),
             lambda: conv_dw.conv_dw_plain(x, gy, k))):
        a, b = got(), want()
        torch.cuda.synchronize()
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())
        del a, b


def test_one_rank_nccl_world_is_bitwise_no_process_group(cuda):
    """Two smoke16 steps in a one-rank nccl world (the gradients and metrics
    all-reduced, an identity) bitwise the same steps without a process
    group."""
    import datetime
    import socket

    import torch.distributed as dist

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire
    from featurenet_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in
                to_wire(generate_batch(rng, 8, 16)).items()} for _ in range(2)]
    cfg = get_config("smoke16", global_batch=8)

    def run():
        tr = Trainer(cfg, device=cuda)
        ms = [{k: v.clone() for k, v in tr.step(b).items()} for b in batches]
        return ms, {k: v.clone() for k, v in tr.state.model.state_dict().items()}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        assert dist.get_backend() == "nccl"
        in_world = run()
    finally:
        dist.destroy_process_group()
    alone = run()
    for a, b in zip(in_world[0], alone[0]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(in_world[1][k], v) for k, v in alone[1].items())


def test_one_slot_elastic_run_trains_on_the_card(cuda, tmp_path):
    """``cli train --elastic --world-size 1`` on the card: the coordinator's
    one child (a world of one, no process group) trains smoke16 under
    pallas on cuda, its kernels launched (smoke16's two 3³ blocks: 2
    forward and 1 dx conv3d_fwd and 2 conv3d_dw a step, the first block's
    input needing no gradient; 2 conv3d_fwd an eval batch), and the
    coordinator exits 0."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = tmp_path / "run"
    out = subprocess.run(
        [sys.executable, "-m", "featurenet_tpu_torch.cli", "train", "--elastic",
         "--world-size", "1", "--config", "smoke16", "--conv-backend", "pallas",
         "--global-batch", "8", "--total-steps", "2", "--eval-batches", "1",
         "--checkpoint-dir", str(tmp_path / "ck"), "--run-dir", str(run)],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    recs = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert recs[-1]["elastic"]["exit_code"] == 0
    assert recs[-1]["elastic"]["generations"] == 1
    launches = [r for r in recs if "launches" in r]
    assert len(launches) == 1
    assert launches[0]["launches"]["conv3d_fwd"] == 2 * 3 + 2
    assert launches[0]["launches"]["conv3d_dw"] == 2 * 2
    spawn = [r for r in recs if r.get("coordinator") == "spawn"]
    assert [r["pid"] for r in spawn] == [launches[0]["pid"]]
    assert not any("distributed" in r for r in recs)
    with open(run / "events.jsonl") as fh:
        events = [json.loads(ln) for ln in fh]
    start = [e for e in events if e["ev"] == "loop_start"]
    assert start[0]["mesh"]["processes"] == 1
    with open(run / "run.json") as fh:
        manifest = json.load(fh)
    assert manifest["pid"] == spawn[0]["pid"]
    assert manifest["torch"]["device_count"] >= 1
