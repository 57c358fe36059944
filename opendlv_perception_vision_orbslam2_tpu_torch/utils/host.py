"""Device->host reads that never stall the tracking thread."""

from __future__ import annotations

import torch


class HostFetch:
    """A device->host copy of a few small tensors that completes in stream
    order: pinned buffers filled ``non_blocking``, a CUDA event recorded
    behind them.  ``done()`` polls the event, ``result()`` waits on it (the
    counterpart of the reference package's worker-thread ``bg_fetch``).  On
    the CPU the copy is immediate."""

    def __init__(self, *tensors):
        self._event = None
        if tensors[0].is_cuda:
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = [t.detach().clone() for t in tensors]

    def done(self) -> bool:
        return self._event is None or self._event.query()

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        out = [h.numpy() for h in self._host]
        return out[0] if len(out) == 1 else out
