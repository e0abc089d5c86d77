"""Fault injection of the PyTorch port (counterpart of ``mxnet_tpu/chaos/``):
the failpoints only.  The composed scenarios of ``chaos/harness.py`` and the
soak loop are not ported.

    import mxnet_tpu_torch.chaos as chaos
    chaos.arm("serving/generation/decode", "raise", hits=2, count=1)
    ...
    chaos.reset()
"""
from .failpoints import (ACTIONS, SITES, ChaosInjectedError, arm, arms, failpoint,
                         failpoint_bytes, reset)

__all__ = ["ACTIONS", "SITES", "ChaosInjectedError", "arm", "arms", "failpoint",
           "failpoint_bytes", "reset"]
