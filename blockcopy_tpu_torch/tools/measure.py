"""What ``chip_smoke.py`` and the tools share: the synthetic clip, the
SwiftNet stepper they drive, and device timing by CUDA graph replay."""

from __future__ import annotations

import statistics

import torch


def synthetic_frames(shape, count, dtype, seed=0, device="cuda"):
    """Synthetic moving frames (a bright square sliding along the diagonal
    over fixed noise, as ``bench.py``), made on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    base = torch.randn(shape, generator=gen, device=device)
    out = []
    for t in range(count):
        f = base.clone()
        s = (t * 37) % (shape[1] - 200)
        f[:, s:s + 160, s:s + 160] += 2.0
        out.append(f.to(dtype))
    return out


def swiftnet_stepper(backbone, frame_shape, capacity, dtype, device,
                     train_interval=4):
    """Random SwiftNet parameters (seed 0) and a fixed-capacity stepper with
    the fast policy, block 128, target 0.5."""
    from blockcopy_tpu_torch.core.stepper import (FixedCapacityStepper,
                                                  StepperConfig)
    from blockcopy_tpu_torch.models.swiftnet import (SwiftNetConfig,
                                                     init_swiftnet,
                                                     make_apply_fn)
    cfg = SwiftNetConfig(backbone=backbone, num_classes=19)
    params = init_swiftnet(cfg, seed=0, dtype=dtype, device=device)
    scfg = StepperConfig(block_size=128, block_target=0.5,
                         train_interval=train_interval, policy_arch="fast")
    return params, FixedCapacityStepper(make_apply_fn(cfg), scfg, frame_shape,
                                        capacity=capacity, dtype=dtype,
                                        device=device)


def device_ms(fn, samples=50, inner=10):
    """Median device time of one call of ``fn``: ``inner`` calls are
    captured in a CUDA graph (so host dispatch does not pace the card) and
    the graph is replayed ``samples`` times between CUDA events, after a
    warm-up on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)
