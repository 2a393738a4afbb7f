"""The system under test for whole-series matching configurations: the
port's matching service.

``MatchSession`` over ``core.distributed.make_engine_service`` on
``make_mesh(shards, device)``, with the sweep kernel the encoder picks
(``kernels.ops.make_pairwise``: K2 for sSAX), the linear
sweep and the verification route of the configuration.  The corpus goes
in through the engine's own ingest, chunk by chunk, as host rows.
"""

from __future__ import annotations

import numpy as np
import torch


def make_encoder(spec: dict):
    from repro_torch.core import SSAX
    kinds = {"ssax": SSAX}
    args = {k: v for k, v in spec.items() if k != "kind"}
    return kinds[spec["kind"]](**args)


class MatchService:
    """Build with the configuration, ``ingest`` the corpus, ``start``,
    ``submit`` single queries, ``close``."""

    def __init__(self, config: dict, traffic: dict, device, metrics):
        from repro_torch.core.distributed import (make_engine_service,
                                                  make_mesh)
        from repro_torch.kernels.ops import make_pairwise
        eng = config["engine"]
        if config["dtype"] != "float32":
            raise ValueError("the matching service serves float32 rows")
        self.encoder = make_encoder(config["encoder"])
        self.mesh = make_mesh(int(eng["shards"]), device)
        self.engine = make_engine_service(
            self.encoder, None, self.mesh,
            batch_size=int(eng["batch_size"]), verify=eng["verify"],
            pairwise=make_pairwise(self.encoder),
            media=eng.get("media", "ssd"), metrics=metrics)
        self.metrics = metrics
        self.session_args = dict(traffic.get("session", {}))
        self.session = None
        self._pinned = None

    def ingest(self, chunk: torch.Tensor) -> None:
        """Append one corpus chunk (device rows) through the engine's
        ingest, which takes host rows: the chunk goes through one pinned
        host buffer, reused."""
        if chunk.device.type == "cpu":
            self.engine.ingest(chunk.numpy())
            return
        n = chunk.shape[0]
        if self._pinned is None or self._pinned.shape[0] < n:
            self._pinned = torch.empty(chunk.shape, dtype=chunk.dtype,
                                       pin_memory=True)
        buf = self._pinned[:n]
        buf.copy_(chunk)
        self.engine.ingest(buf.numpy())

    def start(self) -> None:
        from repro_torch.service import MatchSession
        self._pinned = None
        self.session = MatchSession(self.engine, metrics=self.metrics,
                                    **self.session_args).start()

    def submit(self, query: np.ndarray, k: int):
        return self.session.submit(query, k=k)

    @property
    def n_rows(self) -> int:
        return int(self.engine.store.n)

    def close(self) -> None:
        if self.session is not None:
            self.session.close()
            self.session = None
        self.engine = None


def build(config: dict, traffic: dict, device, metrics) -> MatchService:
    return MatchService(config, traffic, device, metrics)
