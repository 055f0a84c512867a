"""The batched, prefetched predict loop of the test CLI and the eval hook.

Counterpart of ``unibev_tpu/runtime/predict.py::predict_dataset`` on one
device.  A background thread reads and collates the next chunk of samples
into (pinned, on the card) host tensors while the device works on the
current one; copies to the device are ``non_blocking``; ``model.predict``
runs and its outputs come back to the host.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
from torch import nn

from unibev_tpu_torch.data.loader import to_tensors
from unibev_tpu_torch.parallel.train_state import compute_autocast, eval_mode


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The batch's tensors on ``device`` (``non_blocking``: from pinned memory
    the copies overlap the host), without ``img_metas``."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()
            if k != "img_metas"}


def predict_dataset(model: nn.Module, dataset, idxs: Sequence[int],
                    collate: Callable, batch_size: int = 1, prefetch: int = 2,
                    ) -> Iterator[Tuple[Sequence[int], List[dict],
                                        Dict[str, torch.Tensor],
                                        Dict[str, Any]]]:
    """Yield (chunk, metas, device batch, host outputs) per batch of
    ``batch_size`` dataset indices.  The ragged tail is padded by repeating
    its last sample; ``chunk`` holds only the real indices.  The outputs
    are ``model.predict``'s (in eval mode and the model's compute dtype, the
    model's own mode restored) on the host, floats as float32, plus
    ``sca_overflow`` as an int that is -1 where the camera branch did not
    run, and ``wait_s`` / ``predict_s``, the host's wait for the batch and
    its copy, predict and read-back time."""
    device = next(model.parameters()).device
    pin = device.type == "cuda"
    chunks = [idxs[i:i + batch_size] for i in range(0, len(idxs), batch_size)]

    def make_batch(chunk):
        samples = [dataset[int(i)] for i in chunk]
        while len(samples) < batch_size:        # pad the ragged tail
            samples.append(samples[-1])
        b = collate(samples)
        metas = b.pop("img_metas", [{}] * batch_size)
        return chunk, metas, to_tensors(b, pin)

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has gone; False if it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for c in chunks:
                if not put(make_batch(c)):
                    return
            put(None)
        except BaseException as e:   # surface loader errors to the consumer
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            chunk, metas, host = item
            t1 = time.perf_counter()
            b = to_device(host, device)
            with eval_mode(model), compute_autocast(model):
                out = model.predict(b)
            camera = model.use_camera and "img" in b
            out = {k: (v.float() if v.is_floating_point() else v).cpu()
                   for k, v in out.items()}
            out["sca_overflow"] = int(out["sca_overflow"]) if camera else -1
            out["wait_s"] = t1 - t0
            out["predict_s"] = time.perf_counter() - t1
            yield chunk, metas, b, out
    finally:
        stop.set()
        thread.join()
