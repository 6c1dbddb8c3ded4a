"""Tiny configurations of the benchmark's families for the CPU tests: the
same code paths as the cells, at sizes a test run holds."""

# 16 images of 32x32: on fewer, smaller images BatchNorm's folded scales make
# the GGN so ill-conditioned that CG drifts from its float64 reference within
# the solve's first half
RESNET = dict(family="resnet", block="basic", layers=[1, 1, 1, 1], widths=[16, 16, 32, 32],
              stem_width=16, stem_kernel=7, stem_stride=2, num_classes=10, image_size=32,
              channels=3, batch_size=16, bn_calibration_images=16, dtype="float64", tf32=False)
GPT = dict(family="gpt", block_size=16, vocab_size=32, n_layer=2, n_head=2, n_embd=16,
           batch_size=2, dtype="float64", tf32=False)
CONFIGS = {"resnet": RESNET, "gpt": GPT}
# each cell of BENCHMARK.json with the tiny configuration of its family
CELLS = {"resnet18.kfac_step": RESNET, "gpt2s.kfac_step": GPT,
         "resnet18.cg_ggn": RESNET, "gpt2s.cg_ggn": GPT}
