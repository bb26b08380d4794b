"""The served program of each architecture, one module each: how the
harness builds a configuration's stepper, reads what it served, and lists
K1's launches.

A configuration names its module by a dotted path (``"program":
"programs.swiftnet"``); ``of`` finds it.  A module gives

- ``stepper(cfg, scfg, shape, capacity, dtype, device)``: the program's
  stepper over frames of ``shape`` (N, H, W, 3), built as its CLI's speed
  mode builds it (``scfg`` the ``StepperConfig`` the harness makes);
- ``served(state)``: the state's tensors that hold a frame's served
  outputs and its grid (``grid``), views with no copy;
- ``reference_layout(rec, geom)``: a frame recorded from ``served``, in
  the layout ``reference/clip.py`` ``Served`` holds, and its grid (gh, gw);
- ``k1_head(cfg, block_size)``: K1's launches after the backbone, (bs, C,
  pad) in the order the model runs them;

and may give ``blocks(cfg, block_size)``, its backbone's blocks in order
(``work/k2.py`` ``Block``), where ``work/k2.py`` ``blocks``' walk of a
ResNet does not fit it.  A module imports the program inside ``stepper``
alone: the work counts read the rest without loading it.
"""

import importlib
import importlib.util

KEY = "program"


def of(cfg):
    """The module ``cfg["program"]`` names.  Raises ``LookupError`` where
    the configuration has no such key or no such module is found: nothing
    stands in for it."""
    name = cfg.get("name", "<unnamed>")
    if KEY not in cfg:
        raise LookupError(f"configuration {name!r} has no {KEY!r} key: it "
                          f"names the module of its served program, as "
                          f"\"programs.swiftnet\"")
    where = cfg[KEY]
    try:
        found = importlib.util.find_spec(where) is not None
    except ModuleNotFoundError:
        found = False
    if not found:
        raise LookupError(f"configuration {name!r}: {KEY!r} names "
                          f"{where!r}, which is no module")
    return importlib.import_module(where)
