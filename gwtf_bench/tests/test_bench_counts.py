"""The work counts against values worked out by hand."""

import pytest

from gwtf_bench import peaks, run, work
from gwtf_bench.kernels import train_decode_bwd, train_decode_fwd

SPEC = run.Spec()
AIRPLANE = SPEC.config(SPEC.cell("airplane.train"))
SVR = SPEC.config(SPEC.cell("svr.train"))


def test_decoder_shapes_follow_the_published_budget():
    assert work.decoder_shape(AIRPLANE) == (33, 37)
    assert work.decoder_shape(SVR) == (33, 33)


def test_pointnet_flop():
    # 2 (3*64 + 64*128 + 128*256 + 256*512) a point
    assert work.pointnet_flop(AIRPLANE, 1) == 344_448


def test_resnet18_flop():
    # conv1 112^2 * 64 * 4 * 49 * 2; layer1 4 convs 56^2 * 64 * 64 * 9 * 2;
    # layer2-4: a strided 3x3, three 3x3 and a 1x1 downsample each; fc
    convs = 2 * 112 * 112 * 64 * 4 * 49 + 4 * 2 * 56 * 56 * 64 * 64 * 9
    for cin, cout, hw in ((64, 128, 28), (128, 256, 14), (256, 512, 7)):
        convs += 2 * hw * hw * cout * (cin * 9 + 3 * cout * 9 + cin)
    assert work.resnet18_flop(224, 224) == convs + 2 * 512 * 512


def test_train_flop_per_cloud():
    decoder = 4 * 2048 * 33 * (4 * 37 * 37 + 24 * 37)
    assert work.train_flop_per_cloud(AIRPLANE, False) == 3 * (
        decoder + 2048 * 344_448)
    decoder = 4 * 2500 * 33 * (4 * 33 * 33 + 24 * 33)
    assert work.train_flop_per_cloud(SVR, True) == 3 * (
        decoder + 2500 * 344_448 + work.resnet18_flop(224, 224))


def test_kernel_bounds():
    # kernel 7 at B=64 (the kernel table's row 7): 1.643 ms of operations
    ms, by = peaks.bound_ms(**train_decode_fwd.work(4, 64, 2048, 33, 37))
    assert by == "operations"
    assert ms == pytest.approx(4 * 64 * 2048 * 33 * 6364 / 67e9)
    assert ms == pytest.approx(1.643, abs=5e-4)
    ms, by = peaks.bound_ms(**train_decode_bwd.work(4, 64, 2048, 33, 37))
    assert ms == pytest.approx(5.159, abs=5e-4) and by == "operations"


def test_bound_takes_bytes_when_they_are_slower():
    ms, by = peaks.bound_ms(flop=1.0, nbytes=3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    # special-function operations split with the FP32 pipe
    ms, _ = peaks.bound_ms(sfu=peaks.SFU_OPS)
    assert ms < 1e3
