"""``test_torch_detection_engine.py``'s clip with the ``ref`` policy
architecture: the port's ``CSPBlockCopy`` against JAX's over 4 frames of
``rl_objectdetection``, held as that file's docstring says (``ref``: 3e-2
on the policy update).  A file of its own, so that neither file takes a
minute on the CPU."""

from test_torch_detection_engine import rl_clip_matches_jax
from torch_port_util import two_torch_threads  # noqa: F401


def test_rl_objectdetection_ref_matches_jax(monkeypatch):
    rl_clip_matches_jax(monkeypatch, "ref")
