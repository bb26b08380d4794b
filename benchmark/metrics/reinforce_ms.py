"""The REINFORCE update's cost: the mean completion interval of train
frames less that of plain frames, over the window's frames outside the
profiled clips, on every rank."""


def read(run, log):
    train, plain = [], []
    for r in run["ranks"]:
        for ms, kind, prof in zip(r["intervals_ms"], r["kinds"],
                                  r["profiled"]):
            if not prof:
                (train if kind == "train" else plain if kind == "plain"
                 else []).append(ms)
    if not train or not plain:
        log("reinforce_ms: no train or plain frame in the window")
        return None
    return sum(train) / len(train) - sum(plain) / len(plain)
