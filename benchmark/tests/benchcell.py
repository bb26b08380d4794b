"""Cells cut to a size a CPU test run holds: 128x256 frames, block 64
(a 2 x 4 grid), short clips, the served dtype float32, the program on the
CPU through its plain versions with its policy's convolutions in float32
(``fp32_policy``), so that a sound run reads rounding only and each
planted fault stands out against the cells' limits."""

import copy

import torch

from harness import cell as cells

SEED = 2 ** 40 + 17


def tiny(workload: str, clip_length: int = 4, **load):
    """``load``: ``harness.cell.load``'s other arguments."""
    c = cells.load(workload, **load)
    c = copy.deepcopy(c)
    c.cfg.update(height=128, width=256, clip_length=clip_length,
                 dtype="float32")
    c.traffic.update(block_size=64, clips=2, square=40, step=9)
    return c


def fp32_policy() -> None:
    from blockcopy_tpu_torch.policy import net
    net.COMPUTE_DTYPE = torch.float32


def run(cell, trace=False, seconds=0.3, seed=SEED, **kw):
    """The result line's object of a CPU run (the first two clips
    profiled where ``trace``)."""
    from blockcopy_tpu_torch.policy import net
    from harness import main, window
    torch.set_num_threads(4)
    saved = window.PROFILED, net.COMPUTE_DTYPE
    window.PROFILED = (1, 2)
    fp32_policy()
    try:
        return main.run(cell, seed, seconds, trace, 0.0, device="cpu",
                        log=kw.get("log", lambda msg: None))[0]
    finally:
        window.PROFILED, net.COMPUTE_DTYPE = saved


def run_ranks(rank_fn, *args):
    """The clip-parallel cell on two gloo ranks on the CPU through the
    program's launcher, each rank running ``rank_fn(group, cell, *args)``:
    (the result line's object, the ranks' reports)."""
    from blockcopy_tpu_torch.parallel import clip_parallel
    from harness.check import limits
    from harness.report import assemble
    cell = tiny("semseg-rn50-b128-t05-x4")
    cell.chips = 2
    spec = clip_parallel.make_group(2, ["cpu", "cpu"], backend="gloo")
    reports = clip_parallel.spawn(spec, rank_fn, cell, *args, timeout=600)
    return assemble(cell, reports, False, "cpu", limits(cell.name),
                    lambda msg: None), reports


def serve_as_rank(group, cell, plant=None):
    """One rank of ``run_ranks`` at the tiny size; ``plant()``, where
    given, runs in the rank first."""
    from harness.main import rank_main
    import harness.window as window
    fp32_policy()
    if plant is not None:
        plant()
    window.PROFILED = (1, 2)
    return rank_main(group, cell, SEED, 0.3, False, 0.0)


def spy_k1(monkeypatch) -> dict:
    """The halo exchanges the served program makes, (bs, C, pad) each in
    the order made, by kind (``gather``: ``ExecCtx.exchange``, ``pieces``:
    ``ExecCtx.exchange_pieces``); its shape pass, which fuses nothing, left
    out."""
    from blockcopy_tpu_torch.core.blocked import ExecCtx
    seen = {"gather": [], "pieces": []}

    def spy(kind, orig):
        def fn(self, name, x, pad):
            if not self.building:
                seen[kind].append((x.data.shape[1], x.data.shape[-1], pad))
            return orig(self, name, x, pad)
        return fn
    monkeypatch.setattr(ExecCtx, "exchange",
                        spy("gather", ExecCtx.exchange))
    monkeypatch.setattr(ExecCtx, "exchange_pieces",
                        spy("pieces", ExecCtx.exchange_pieces))
    return seen
