"""The port's self-trained nets and their sampler on a CUDA card: every
synthetic face is one launch of the composite kernel K1 (no residual, no K2),
K1 agrees with its plain version on a sampler frame (96^2: 36 tiles, K = 128,
one splat per face of the 5143-vertex asset, lists that overflow K), a sampler
batch and a detector step make no host sync, both nets agree with themselves
on the CPU, and training takes the card by default.  Without a card every
test here skips.

This file imports only the port (no jax), so it also runs on a machine
without JAX:  python -m pytest --noconftest tests/test_torch_nets_card.py
"""

import numpy as np
import pytest
import torch

from omfs4d_torch.models.assets import synthetic_flame_asset
from omfs4d_torch.models.flame import FlameModel
from omfs4d_torch.models.gaussians import bind_to_mesh, eval_colors
from omfs4d_torch.ops.camera import project_gaussians
from omfs4d_torch.render import composite as tc
from omfs4d_torch.render.rasterize import bin_gaussians
from omfs4d_torch.track import detector as tdet
from omfs4d_torch.track import matting as tmat
from omfs4d_torch.track import segnet as tseg
from omfs4d_torch.train.trainer import adam_init

S = 96
K = 128
TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the composite kernels have no CPU mode")
    return torch.device("cuda", 0)


def full_model(device):
    return FlameModel.from_asset(synthetic_flame_asset(n_vertices=5143, seed=0), device=device)


def sampler_frame_inputs(sampler, draws, i):
    """The composite's inputs of sample i, as `picture` reaches them."""
    with torch.no_grad():
        verts, w2c, logits = sampler.scene(draws)
        g = sampler.splats(logits[i])
        cam = sampler.camera(draws, w2c, i)
        means, rot, scales, opac, _ = bind_to_mesh(g, verts[i], sampler.model.faces)
        cols = eval_colors(g, means, cam.position)
        proj = project_gaussians(cam, means, rot, scales)
        binning = bin_gaussians(proj, opac, sampler.size, sampler.size,
                                max_per_tile=sampler.max_per_tile)
    return proj["uv"], proj["conic"], cols, opac, binning, sampler.size, sampler.size


def test_k1_matches_its_plain_version_on_sampler_frames(cuda_device):
    sampler = tdet.SyntheticFaceSampler(full_model(cuda_device), S)
    draws = sampler.draw(torch.Generator(device=cuda_device).manual_seed(0), 4)
    overflowed = 0
    for i in range(4):
        args = sampler_frame_inputs(sampler, draws, i)
        assert args[4].tile_lists.shape == (36, K) and args[0].shape[0] == 10282
        overflowed += int(args[4].overflow)
        img_k, alpha_k = tc.composite(*args)
        img_p, alpha_p = tc.composite_plain(*args)
        assert bool(torch.isfinite(img_k).all())
        assert float((img_k - img_p).abs().max()) <= TOL
        assert float((alpha_k - alpha_p).abs().max()) <= TOL
    assert overflowed > 0          # one splat per face on 36 tiles: K = 128 is exceeded


def test_a_batch_launches_k1_once_per_face_and_never_syncs(cuda_device):
    sampler = tdet.SyntheticFaceSampler(full_model(cuda_device), S)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    sampler.batch(gen, 2)                       # warm-up: the kernel's build, the allocator
    torch.cuda.synchronize()
    fwd, bwd = tc.composite.launches, tc.composite.backward_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        images, labels, alpha = sampler.batch(gen, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tc.composite.launches - fwd == 8 and tc.composite.backward_launches == bwd
    assert images.shape == (8, S, S, 3) and labels.shape == (8, 68, 2) and alpha.shape == (8, S, S)
    assert images.device == cuda_device and not images.requires_grad
    assert bool(torch.isfinite(images).all()) and 0.0 <= float(images.min())
    assert float(images.max()) <= 1.0 and 0.05 < float((alpha > 0.5).float().mean()) < 0.95


def test_a_detector_step_and_a_segnet_step_make_no_host_sync(cuda_device):
    sampler = tdet.SyntheticFaceSampler(full_model(cuda_device), S)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    net = tdet.init_net(gen, 68, S)
    seg = tseg.init_segnet(gen, S)
    states = adam_init(dict(net.named_parameters())), adam_init(dict(seg.named_parameters()))
    schedule = tdet.cosine_decay_schedule(3e-4, 10, alpha=0.1)

    def steps():
        images, labels, alpha = sampler.batch(gen, 4)
        tdet.adam_step(net, states[0], tdet.detector_loss(net, images, labels), schedule)
        tdet.adam_step(seg, states[1], tseg.segnet_loss(seg, images, alpha), schedule)

    steps()                                     # warm-up: cuDNN picks its algorithms
    before = net.head.weight.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(states[0]["count"]) == 2 == int(states[1]["count"])
    assert not torch.equal(before, net.head.weight)
    assert all(p.device == cuda_device for p in [*net.parameters(), *seg.parameters()])


def test_both_nets_on_the_card_agree_with_the_cpu(cuda_device):
    """TF32 is off package-wide (omfs4d_torch/__init__.py): the convolutions
    run in f32 on the card.  Landmarks atol 1e-4 (normalized), logits atol
    1e-4 * max|logit|."""
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    gen = torch.Generator().manual_seed(0)
    net, seg = tdet.init_net(gen, 68, S), tseg.init_segnet(gen, S)
    images = torch.rand((4, S, S, 3), generator=gen)
    with torch.no_grad():
        want_uv, want_logits = tdet.net_apply(net, images), tseg.segnet_apply(seg, images)
        got_uv = tdet.net_apply(net.to(cuda_device), images.to(cuda_device)).cpu()
        got_logits = tseg.segnet_apply(seg.to(cuda_device), images.to(cuda_device)).cpu()
    assert float((got_uv - want_uv).abs().max()) <= 1e-4
    assert float((got_logits - want_logits).abs().max()) <= 1e-4 * float(want_logits.abs().max())


def test_training_takes_the_card_and_detection_runs_there(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setenv("OMFS4D_CACHE", str(tmp_path / "cache"))
    model = FlameModel.from_asset(synthetic_flame_asset(n_vertices=700, seed=0))   # on the CPU
    fwd = tc.composite.launches
    history = []
    net = tdet.train_detector(model, steps=3, batch_size=4, image_size=64, log_every=0,
                              history=history)
    assert net.log_temp.device == cuda_device and tc.composite.launches - fwd == 12
    assert len(history) == 3 and all(h.device == cuda_device for h in history)
    seg = tseg.get_or_train_segnet(model, weights=tmp_path / "seg.npz", image_size=64, steps=2)
    assert seg.out.weight.device == cuda_device and (tmp_path / "seg.npz").exists()
    frames = np.random.default_rng(0).integers(0, 256, (3, 80, 96, 3)).astype(np.uint8)
    lmk, valid = tdet.detect(net, frames)
    assert lmk.shape == (3, 68, 2) and valid.all() and np.isfinite(lmk).all()
    masks = tseg.predict_masks(seg, frames, image_size=64)
    assert masks.shape == (3, 80, 96) and set(np.unique(masks)) <= {0.0, 1.0}
    # a weights file loaded with no device named goes to the card too
    tdet.save_detector(tmp_path / "net.npz", net)
    loaded = tdet.load_detector(tmp_path / "net.npz")
    loaded_seg = tseg.load_segnet(tmp_path / "seg.npz")
    assert loaded.log_temp.device == cuda_device and loaded_seg.out.weight.device == cuda_device
    np.testing.assert_array_equal(tdet.detect(loaded, frames)[0], lmk)
    np.testing.assert_array_equal(tseg.predict_masks(loaded_seg, frames, image_size=64), masks)
    # border_color classifies on the card and agrees with the CPU
    on_card = tmat.compute_masks(frames, method="border_color")
    on_cpu = tmat.compute_masks(frames, method="border_color", device="cpu")
    assert (on_card != on_cpu).mean() <= 1e-4
