"""``work.py``'s counts against hand counts."""

import importlib

import pytest
from tiny import CONFIGS

from perfbench import harness, work
from perfbench.devtrace import Trace
from perfbench.reference import gpt, resnet


def test_one_conv_by_hand():
    # layer1's 3x3 conv of ResNet-18 on CIFAR-10 at batch 512: 64 channels at
    # 8 x 8, d = 9 * 64 = 576 and 512 * 64 patch rows; the symmetric output's
    # d (d + 1) / 2 dot products over the rows, 2 operations a multiply-add
    conv = dict(c_in=64, c_out=64, k=3, s=1, hw=8)
    flops = 512 * 64 * 576 * 577
    nbytes = (512 * 64 * 8 * 8 + 576 * 576) * 4
    seconds, what = work.conv_cov_bound(512, conv)
    assert what == "operations"
    assert seconds == pytest.approx(max(flops / (495e12 / 3), nbytes / 3.35e12))


def test_one_flash_call_by_hand():
    # the forward at [4, 12, 1024, 64]: q k^T and P v over the 1024 * 1025 / 2
    # visible pairs of each of 48 heads, 2 * 64 operations a product
    flops = 2 * 2 * 64 * 48 * 1024 * 1025 / 2
    seconds, what = work.flash_bound("fwd", 4, 12, 1024, 64, 4)
    assert what == "operations"
    assert seconds == pytest.approx(flops / (495e12 / 3))
    assert seconds * 1e3 == pytest.approx(0.0391, abs=5e-5)  # chip_smoke.py's kernel table
    assert work.flash_bound("bwd_dkv", 4, 12, 1024, 64, 4)[0] == pytest.approx(2 * seconds)


def test_resnet18_shapes():
    cfg = dict(family="resnet", block="basic", layers=[2, 2, 2, 2], widths=[64, 128, 256, 512],
               stem_width=64, stem_kernel=7, stem_stride=2, channels=3, image_size=32,
               num_classes=10, batch_size=512)
    convs = resnet.convs(cfg)
    assert len(convs) == 20 and convs[0]["k"] == 7
    assert sum(c["c_in"] >= 16 for c in convs) == 19  # the convs after the stem
    # one image's multiply-adds: convs and head
    macs = sum((-(-c["hw"] // c["s"])) ** 2 * c["k"] ** 2 * c["c_in"] * c["c_out"] for c in convs)
    assert work.forward_flops(cfg) == 2 * 512 * (macs + 512 * 10)


def test_gpt2_small_forward():
    cfg = dict(family="gpt", n_layer=12, n_head=12, n_embd=768, block_size=1024,
               vocab_size=50304, batch_size=4)
    C, T, B = 768, 1024, 4
    per_token = 12 * (2 * 12 * C * C + 2 * C * (T + 1)) + 2 * C * 50304
    assert work.forward_flops(cfg) == pytest.approx(B * T * per_token)


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_counts_come_from_the_family_module(family):
    # work.py counts a configuration by its family's module alone
    cfg = CONFIGS[family]
    module = importlib.import_module(f"perfbench.reference.{family}")
    assert work.kfac_layers(cfg) == module.kfac_shapes(cfg)
    assert work.forward_flops(cfg) == module.forward_flops(cfg)
    assert len(module.kfac_shapes(cfg)) == len(module.kfac_layers(cfg))


@pytest.mark.parametrize("family", sorted(CONFIGS))
@pytest.mark.parametrize("metric", ["conv_cov_roofline", "flash_roofline"])
def test_roofline_reads_nothing_without_its_kernels(metric, family):
    # a trace without the metric's kernels: nothing to read, in any family
    run = harness.Run(CONFIGS[family], {}, work, {"factor_pass": [0.1]}, 1, 1.0,
                      Trace(busy_s=0.5, window_s=1.0, kernel_s={"gemm": 0.5}, launches={"gemm": 3}))
    assert harness.metric_reader(metric)(run) is None


def test_flash_roofline_counts_each_launch():
    cfg = CONFIGS["gpt"]
    shape = gpt.attention_shape(cfg)
    names = {"fwd": "flash_fwd_kernel", "bwd_dkv": "flash_bwd_dkv_kernel",
             "bwd_dq": "flash_bwd_dq_kernel"}
    launches = {"fwd": 3, "bwd_dkv": 2, "bwd_dq": 2}
    least = sum(n * work.flash_bound(k, *shape, 4)[0] for k, n in launches.items())
    trace = Trace(busy_s=1.0, window_s=1.0,
                  kernel_s={names[k]: 2 * least / 3 for k in names},
                  launches={names[k]: n for k, n in launches.items()})
    run = harness.Run(cfg, {}, work, {}, 1, 1.0, trace)
    assert harness.metric_reader("flash_roofline")(run) == pytest.approx(50.0)
