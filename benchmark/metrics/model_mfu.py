"""The model's FLOPs (2 x the benchmark's MAC count of each frame's kind)
over the frames' completion intervals and the card's peak (bf16 989
TFLOP/s; fp32 storage against TF32's 495), over the window's frames
outside the profiled clips, averaged over ranks."""


def read(run, log):
    shares = []
    for r in run["ranks"]:
        frames = [(k, ms) for k, ms, prof in zip(r["kinds"], r["intervals_ms"],
                                                 r["profiled"]) if not prof]
        if not frames:
            continue
        flops = sum(2 * run["macs"][k] for k, _ in frames)
        seconds = sum(ms for _, ms in frames) / 1e3
        shares.append(100.0 * flops / (seconds * run["peak_flops"]))
    if not shares:
        log("model_mfu: no frame outside the profiled clips")
        return None
    return sum(shares) / len(shares)
