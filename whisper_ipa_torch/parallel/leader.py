"""Rank 0 leads, the other ranks follow: the command channel of the
services that run over a mesh (``serve.TranscriptionService`` and
``serve_continuous.ContinuousBatcher``).

Rank 0 owns the queue and the host loop. It broadcasts one command at a
time over the world, a code and an integer argument, and then runs the
command's body; every other rank waits in ``follow``, receives the command
and runs the same body, so the body's collectives meet on every rank. A
service numbers its own commands from 0; the channel's are negative.

When rank 0's loop fails, ``fail`` releases the followers instead of
leaving them waiting for a command that never comes. Between commands it
sends ``FAILED``, and each follower raises. Inside a command the followers
may be waiting in one of its collectives, which no broadcast can reach:
the process group is torn down, so that their pending collective raises
(gloo reports the closed connection at once; NCCL at its timeout).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict

import torch
import torch.distributed as dist

from . import distributed as D

STOP, BEAT, FAILED = -1, -2, -3


class LeaderFailed(RuntimeError):
    """Raised on a follower when rank 0's loop failed."""


class Leader:
    """The command channel of one service. Without a mesh (``enabled``
    False) every method is a no-op and ``follow`` returns at once."""

    IDLE_BEAT_SEC = 5.0  # an idle leader's heartbeat to the followers

    def __init__(self, device: torch.device, enabled: bool = True):
        self.device = device
        self.enabled = enabled
        self._last = time.time()
        self._open = False  # a command's body is running on rank 0

    def send(self, cmd: int, arg: int = 0) -> None:
        """Rank 0's command to every rank, with no body (``STOP``, a halt
        that every rank applies to its own state)."""
        if self.enabled:
            D.broadcast(torch.tensor([cmd, arg], dtype=torch.long,
                                     device=self.device), src=0)
            self._last = time.time()

    @contextmanager
    def command(self, cmd: int, arg: int = 0):
        """Rank 0's command, then its body (the ``with`` block), which the
        followers run too. A body that raises leaves the command open for
        ``fail``."""
        self.send(cmd, arg)
        self._open = True
        yield
        self._open = False

    def beat(self) -> None:
        """An idle leader's heartbeat: ``BEAT`` when nothing went out for
        IDLE_BEAT_SEC, so that a follower's wait stays inside the process
        group's timeout."""
        if self.enabled and time.time() - self._last > self.IDLE_BEAT_SEC:
            self.send(BEAT)

    def stop(self) -> None:
        self.send(STOP)

    def fail(self) -> None:
        """Release the followers after rank 0's loop failed (see the
        module's docstring)."""
        if not self.enabled:
            return
        if self._open:
            dist.destroy_process_group()
        else:
            self.send(FAILED)

    def follow(self, bodies: Dict[int, Callable[[int], None]]) -> None:
        """A follower's loop: run ``bodies[cmd](arg)`` for each command
        rank 0 sends, until it stops; raises ``LeaderFailed`` when rank 0's
        loop failed."""
        if not self.enabled:
            return
        while True:
            t = torch.zeros(2, dtype=torch.long, device=self.device)
            cmd, arg = D.broadcast(t, src=0).tolist()
            if cmd == STOP:
                return
            if cmd == FAILED:
                raise LeaderFailed("rank 0's loop failed; its followers stop")
            if cmd != BEAT:
                bodies[cmd](arg)
