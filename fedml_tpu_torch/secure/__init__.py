"""Secure-aggregation data plane (port of fedml_tpu/secure/).

``core/mpc.py`` holds the finite-field control plane (BGW shares, DH key
agreement, fixed-point quantization); ``secagg.py`` wires them into the
aggregation path: pairwise-mask uplinks, dropout recovery at the commit
barrier, and the field fold on the server's device.
"""
from fedml_tpu_torch.secure.secagg import (SecAggBelowThreshold, SecAggConfig,
                                           SecAggKeyring, SecureAggregator,
                                           pairwise_mask)

__all__ = ["SecAggBelowThreshold", "SecAggConfig", "SecAggKeyring",
           "SecureAggregator", "pairwise_mask"]
