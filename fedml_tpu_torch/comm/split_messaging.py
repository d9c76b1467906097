"""Remote SplitNN — the per-batch activation/gradient protocol over the
message layer (port of fedml_tpu/comm/split_messaging.py).

Parity: fedml_api/distributed/split_nn/ — message_define.py:5-25 (types),
client_manager.py:17-107 (semaphore round-robin, acts up / grads down,
per-epoch validation), server_manager.py:14-45, client.py:24-41,
server.py:40-72.  SURVEY.md §3.4 calls this the comm-layer stress test: the
process boundary is crossed TWICE PER MINIBATCH.

The numerics run on each side's device (the card unless the caller names
another): `SplitClientCompute.forward/backward` and
`SplitServerCompute.train_step` hold their half as a flat vector
(core/flatmodel.py) stepped by the port's optimizer, whose state persists
across batches (the reference builds optim.SGD once).  The protocol layer
moves the activations and gradients as tensors through Message frames
(copied to the host at encode, decoded as CPU tensors), so it runs over
any backend (INPROC, GRPC, TCP/native).  Unlike the reference we also
ship the batch mask (our shards are padded) and reset per-epoch batch
counters cleanly (the reference reuses a single counter across train and
eval, client_manager.py:40-56).
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Optional

import torch

from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.trainer import (make_optimizer, masked_accuracy_sums,
                                          masked_cross_entropy)
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)
Pytree = Any


class SplitNNMessage:
    """Message-type constants (message_define.py:5-25)."""
    MSG_TYPE_S2C_GRADS = 1
    MSG_TYPE_C2S_SEND_ACTS = 2
    MSG_TYPE_C2S_VALIDATION_MODE = 3
    MSG_TYPE_C2S_VALIDATION_OVER = 4
    MSG_TYPE_C2S_PROTOCOL_FINISHED = 5
    MSG_TYPE_C2C_SEMAPHORE = 6

    MSG_ARG_KEY_ACTS = "activations"
    MSG_ARG_KEY_LABELS = "labels"
    MSG_ARG_KEY_MASK = "mask"
    MSG_ARG_KEY_GRADS = "activation_grads"
    MSG_ARG_KEY_PHASE = "phase"


class _HalfCompute:
    """One half of the split net as a flat vector on `device`, with its
    optimizer; params travel as {name: tensor} views of the vector."""

    def __init__(self, model, lr: float, momentum: float,
                 weight_decay: float, optimizer: str, device):
        self.model = model
        self.flat = FlatModel(model)
        self.tx = make_optimizer(optimizer, lr, momentum, weight_decay)
        self.device = resolve_device(device)

    def init(self, generator: Optional[torch.Generator] = None,
             params: Optional[dict] = None):
        """(params, optimizer state): fresh from `generator` (seed 0 if
        None), or `params` (e.g. carried over from the JAX package) moved
        to the device."""
        if params is None:
            params = self.flat.init(generator if generator is not None
                                    else torch.Generator().manual_seed(0),
                                    self.device)
        params = {k: torch.as_tensor(v).to(self.device)
                  for k, v in params.items()}
        return params, self.tx.init(self.flat.flatten(params))

    def _in(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _step(self, p: torch.Tensor, grad: torch.Tensor, opt_state: dict):
        updates, opt_state = self.tx.update(grad, opt_state, p)
        return self.flat.unflatten(p + updates), opt_state


class SplitClientCompute(_HalfCompute):
    """Client lower-net numerics: forward to the cut, backward from the
    server's activation gradients (client.py:24-35)."""

    def __init__(self, model, lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 5e-4, optimizer: str = "sgd",
                 device=None):
        super().__init__(model, lr, momentum, weight_decay, optimizer, device)

    @torch.no_grad()
    def forward(self, params: dict, x) -> torch.Tensor:
        return self.flat(self.flat.flatten(params), self._in(x))

    def backward(self, params: dict, opt_state: dict, x, grads):
        p = self.flat.flatten(params)
        leaf = p.detach().requires_grad_()
        acts = self.flat(leaf, self._in(x))
        (g,) = torch.autograd.grad(acts, leaf,
                                   grad_outputs=self._in(grads).to(acts.dtype))
        return self._step(p, g, opt_state)


class SplitServerCompute(_HalfCompute):
    """Server upper-net numerics: logits + loss + activation gradients in
    one step (server.py:40-60 forward_pass+backward_pass fused)."""

    def __init__(self, model, lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 5e-4, optimizer: str = "sgd",
                 device=None):
        super().__init__(model, lr, momentum, weight_decay, optimizer, device)

    def train_step(self, params: dict, opt_state: dict, acts, y, mask):
        p = self.flat.flatten(params)
        leaf = p.detach().requires_grad_()
        a = self._in(acts).detach().requires_grad_()
        y, mask = self._in(y), self._in(mask)
        logits = self.flat(leaf, a)
        loss = masked_cross_entropy(logits, y, mask)
        gp, ga = torch.autograd.grad(loss, (leaf, a))
        params, opt_state = self._step(p, gp, opt_state)
        correct, count = masked_accuracy_sums(logits.detach(), y, mask)
        return params, opt_state, ga, loss.detach(), correct, count

    @torch.no_grad()
    def eval_step(self, params: dict, acts, y, mask):
        y, mask = self._in(y), self._in(mask)
        logits = self.flat(self.flat.flatten(params), self._in(acts))
        loss = masked_cross_entropy(logits, y, mask)
        correct, count = masked_accuracy_sums(logits, y, mask)
        return loss, correct, count


class SplitNNClientManager(ClientManager):
    """client_manager.py:17-107 over the comm layer.  Clients are ranks
    1..max_rank; rank 1 starts the protocol; after each epoch+validation the
    semaphore passes to node_right."""

    def __init__(self, compute: SplitClientCompute, params, opt_state,
                 train_shard: dict, test_shard: dict, rank: int,
                 max_rank: int, epochs: int, server_rank: int = 0,
                 backend: str = "INPROC",
                 act_transport: Optional[str] = None, **kw):
        """act_transport: opt-in lossy wire dtype ("bf16"/"int8", wire
        codec v2) for the per-batch ACTIVATION payload — the protocol
        crosses the process boundary twice per minibatch, so this is
        where split training's wire bytes live.  Labels/masks stay
        exact (they feed the loss/metric sums); the gradient downlink
        is the server's symmetric knob.  None (default) = exact."""
        super().__init__(rank, max_rank + 1, backend, **kw)
        self.act_transport = act_transport
        self.compute = compute
        self.params, self.opt_state = params, opt_state
        self.train_shard, self.test_shard = train_shard, test_shard
        self.max_rank = max_rank
        self.node_right = 1 if rank == max_rank else rank + 1
        self.server_rank = server_rank
        self.max_epochs = epochs          # MAX_EPOCH_PER_NODE
        self.epoch_count = 0              # this node's completed epochs
        self.batch_idx = 0
        self.phase = "train"
        self.done = threading.Event()

    # -- protocol ------------------------------------------------------------
    def start_protocol(self):
        """Rank 1 kicks off training (client_manager.py:17-21 run())."""
        if self.rank == 1:
            self.run_forward_pass()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(
            SplitNNMessage.MSG_TYPE_C2C_SEMAPHORE, self.handle_semaphore)
        self.register_message_receive_handler(
            SplitNNMessage.MSG_TYPE_S2C_GRADS, self.handle_gradients)

    def _shard(self):
        return self.train_shard if self.phase == "train" else self.test_shard

    def _n_batches(self):
        return self._shard()["x"].shape[0]

    def _batch(self):
        i = self.batch_idx
        s = self._shard()
        return s["x"][i], s["y"][i], s["mask"][i]

    def run_forward_pass(self):
        x, y, mask = self._batch()
        acts = self.compute.forward(self.params, x)
        self._last_x = x
        m = Message(SplitNNMessage.MSG_TYPE_C2S_SEND_ACTS, self.rank,
                    self.server_rank)
        m.add_params(SplitNNMessage.MSG_ARG_KEY_ACTS, acts)
        m.add_params(SplitNNMessage.MSG_ARG_KEY_LABELS, y)
        m.add_params(SplitNNMessage.MSG_ARG_KEY_MASK, mask)
        # the phase rides WITH the activations: over real sockets, messages
        # from different clients arrive on different connections and can
        # reorder vs the VALIDATION_MODE/OVER signals — the server must not
        # infer this batch's phase from its own (possibly stale) state, or
        # a train batch handled in 'validation' never gets its gradients
        # back and that client deadlocks
        m.add_params(SplitNNMessage.MSG_ARG_KEY_PHASE, self.phase)
        if self.act_transport:
            m.set_wire_transport(SplitNNMessage.MSG_ARG_KEY_ACTS,
                                 self.act_transport)
        self.send_message(m)
        self.batch_idx += 1

    def handle_semaphore(self, _msg: Message):
        self.phase, self.batch_idx = "train", 0
        self.run_forward_pass()

    def handle_gradients(self, msg: Message):
        grads = msg.get(SplitNNMessage.MSG_ARG_KEY_GRADS)
        self.params, self.opt_state = self.compute.backward(
            self.params, self.opt_state, self._last_x, grads)
        if self.batch_idx == self._n_batches():
            self.run_eval()
        else:
            self.run_forward_pass()

    def run_eval(self):
        """Per-epoch validation sweep, then hand the semaphore on
        (client_manager.py:44-60)."""
        self.send_signal(SplitNNMessage.MSG_TYPE_C2S_VALIDATION_MODE)
        self.phase, self.batch_idx = "eval", 0
        for _ in range(self._n_batches()):
            self.run_forward_pass()
        self.send_signal(SplitNNMessage.MSG_TYPE_C2S_VALIDATION_OVER)
        self.epoch_count += 1
        if (self.epoch_count == self.max_epochs
                and self.rank == self.max_rank):
            self.send_signal(SplitNNMessage.MSG_TYPE_C2S_PROTOCOL_FINISHED)
        else:
            m = Message(SplitNNMessage.MSG_TYPE_C2C_SEMAPHORE, self.rank,
                        self.node_right)
            self.send_message(m)
        if self.epoch_count == self.max_epochs:
            self.done.set()
            self.finish()

    def send_signal(self, msg_type):
        self.send_message(Message(msg_type, self.rank, self.server_rank))


class SplitNNServerManager(ServerManager):
    """server_manager.py:14-45 + server.py:40-72: owns the upper net,
    answers every train activation with gradients, accumulates validation
    stats, rotates the active node on validation-over."""

    def __init__(self, compute: SplitServerCompute, params, opt_state,
                 max_rank: int, rank: int = 0, backend: str = "INPROC",
                 grad_transport: Optional[str] = None, **kw):
        """grad_transport: the downlink twin of the client's
        act_transport — opt-in lossy wire dtype for the per-batch
        activation-gradient reply (wire codec v2); None = exact."""
        super().__init__(rank, max_rank + 1, backend, **kw)
        self.grad_transport = grad_transport
        self.compute = compute
        self.params, self.opt_state = params, opt_state
        self.max_rank = max_rank
        self.active_node = 1
        self.phase = "train"
        self.epoch = 0
        self._reset_stats()
        self.val_history: list[dict] = []
        self.done = threading.Event()

    def _reset_stats(self):
        self.total = 0.0
        self.correct = 0.0
        self.val_loss_sum = 0.0
        self.step = 0

    def register_message_receive_handlers(self):
        M = SplitNNMessage
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_SEND_ACTS, self.handle_acts)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_VALIDATION_MODE, self.handle_validation_mode)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_VALIDATION_OVER, self.handle_validation_over)
        self.register_message_receive_handler(
            M.MSG_TYPE_C2S_PROTOCOL_FINISHED, self.handle_finish)

    def handle_acts(self, msg: Message):
        acts = msg.get(SplitNNMessage.MSG_ARG_KEY_ACTS)
        y = msg.get(SplitNNMessage.MSG_ARG_KEY_LABELS)
        mask = msg.get(SplitNNMessage.MSG_ARG_KEY_MASK)
        # per-message phase (see client): ordering-independent branch
        phase = msg.get(SplitNNMessage.MSG_ARG_KEY_PHASE, self.phase)
        if phase == "train":
            (self.params, self.opt_state, ga, loss, correct,
             count) = self.compute.train_step(self.params, self.opt_state,
                                              acts, y, mask)
            reply = Message(SplitNNMessage.MSG_TYPE_S2C_GRADS, self.rank,
                            msg.get_sender_id())
            reply.add_params(SplitNNMessage.MSG_ARG_KEY_GRADS, ga)
            if self.grad_transport:
                reply.set_wire_transport(SplitNNMessage.MSG_ARG_KEY_GRADS,
                                         self.grad_transport)
            self.send_message(reply)
            # a train batch reordered past a VALIDATION_MODE reset must not
            # pollute the validation accumulators
            if self.phase == "train":
                self.correct += float(correct)
                self.total += float(count)
                self.step += 1
        else:
            loss, correct, count = self.compute.eval_step(
                self.params, acts, y, mask)
            self.val_loss_sum += float(loss)
            self.correct += float(correct)
            self.total += float(count)
            self.step += 1

    def handle_validation_mode(self, _msg: Message):
        self.phase = "validation"
        self._reset_stats()

    def handle_validation_over(self, _msg: Message):
        """server.py:62-72 validation_over: record stats, rotate the active
        node, back to train mode."""
        acc = self.correct / max(self.total, 1.0)
        self.val_history.append({
            "epoch": self.epoch, "val_acc": acc,
            "val_loss": self.val_loss_sum / max(self.step, 1),
            "active_node": self.active_node})
        log.info("splitnn epoch %d: val_acc=%.4f (node %d)", self.epoch,
                 acc, self.active_node)
        self.epoch += 1
        self.active_node = (self.active_node % self.max_rank) + 1
        self.phase = "train"
        self._reset_stats()

    def handle_finish(self, _msg: Message):
        self.done.set()
        self.finish()
