"""comm — host-side message layer for genuinely-remote participants (port
of fedml_tpu/comm/).

One-card cohorts never touch this package (they run in the engines of
fedml_tpu_torch/algorithms and parallel/).  This layer exists for the
reference's cross-silo / edge deployments where clients are separate
processes or machines: BaseCommunicationManager + Message + Observer
(fedml_core/distributed/communication/, SURVEY.md §2.1) with pluggable
backends — in-process (tests/simulation), gRPC (WAN cross-silo), TCP in
Python (threads or the selector reactor), the native C++ transport
(fedml_tpu_torch/native/) and MQTT (the edge leg, through a broker:
mqtt_backend.py, with the in-repo broker and client of mqtt_wire.py).
Around them: the seeded fault injector (chaos.py, installed with
``install_chaos``), the reliability envelope (reliability.py,
``enable_reliability``) and the connection swarm (connswarm.py), a
one-loop client fleet that loads a server's reactor.

The frames are the JAX package's byte for byte (comm/message.py), so a
port peer and a JAX peer exchange plain array trees over any transport.
This package never imports grpc or paho (backends import lazily): the
card's machine may have neither.

Differences from the reference, by design:
  * no 0.3 s polling loops or killable daemon threads
    (mpi/com_manager.py:71-78, mpi_send_thread.py:47-53) — backends push
    into a blocking queue drained by the manager's run loop;
  * one consistent port scheme (the reference binds 50000+rank but dials
    8888+rank — grpc_comm_manager.py:41-61 — a bug SURVEY.md flags);
  * tensors ride a zero-copy binary codec, with the reference's
    JSON-list mode kept for mobile parity (--is_mobile,
    fedavg/utils.py:7-16).
"""
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.comm.base import BaseCommManager, Observer
from fedml_tpu_torch.comm.chaos import ChaosConfig, ChaosPolicy
from fedml_tpu_torch.comm.inproc import InProcBackend, InProcRouter
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.reactor import (FdExhaustionError, ReactorConfig,
                                          ReactorGroup)
from fedml_tpu_torch.comm.reliability import BackoffPolicy, ReliableEndpoint
