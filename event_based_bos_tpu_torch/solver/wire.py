"""Host→device event upload policy (the serving "wire").

PyTorch counterpart of the JAX package's ``solver/wire.py``:
:class:`WireUploadMixin` owns the ``quantized_upload`` and
``flow_fetch_dtype`` configuration keys and ``_to_events``, the upload every
facade method funnels raw event batches through.  Its attribute names are
the facade's tested surface: ``wire_mode``, ``wire_quantized``,
``_fetch_dtype`` and ``_wire_fell_back``.

The quantized wire (:func:`..types.encode_wire_events`) packs (x, y) on a
1/32-px grid, polarity as int8 and t as µs or raw float32 (5 or 9 B/event
instead of the direct upload's 16); :func:`..types.decode_wire_events`
rebuilds the ``Events`` on the device, once a call (there is nothing to
compile).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..types import (Events, bucket_capacity, decode_wire_events,
                     encode_wire_events, events_from_ndarray)
from ..utils.tracing import span

logger = logging.getLogger(__name__)

__all__ = ["WireUploadMixin", "FETCH_DTYPES"]

#: ``flow_fetch_dtype`` names → the dtype the flow is fetched in (None:
#: float32, no cast)
FETCH_DTYPES = {"float32": None, "float16": torch.float16,
                "bfloat16": torch.bfloat16}


class WireUploadMixin:
    """Upload-policy half of ``SolverBase``.

    Expects the facade to set ``self.dtype`` and ``self.device`` and to
    carry the class flags ``SUPPORTS_FLOW_FETCH_DTYPE`` / ``EVENTS_NEED_T``
    before it calls :meth:`_init_wire`.
    """

    def _init_wire(self, slv_config: dict) -> None:
        """Parse and validate the wire keys (a typo raises).

        ``quantized_upload: true`` / ``exact`` uploads on the exact wire
        (bit-exact for 1/32-px-aligned coordinates; off-µs-grid timestamps
        ride the float32 tier) and warns once, then uploads float32, for a
        batch it cannot carry; ``round`` snaps onto the wire grid (≤ 1/64
        px, ≤ 0.5 µs); ``direct`` always uploads float32.  With no key the
        facade still tries the exact wire at float32 (the opportunistic
        default): its decode equals the direct upload bit for bit, and a
        refused batch uploads directly without a warning.
        ``flow_fetch_dtype: float16`` / ``bfloat16`` fetches the flow in
        that dtype (the facades that support it set
        ``SUPPORTS_FLOW_FETCH_DTYPE``).
        """
        qu = slv_config.get("quantized_upload", False)
        self.wire_mode = ({True: "exact", "exact": "exact",
                           "round": "round", "direct": None}.get(qu, False)
                          if qu else None)
        if self.wire_mode is False:
            raise ValueError(f"quantized_upload: unknown mode {qu!r} "
                             "(expected true, 'exact', 'round' or 'direct')")
        self.wire_quantized = self.wire_mode is not None
        self._wire_opportunistic = not self.wire_quantized and qu != "direct"
        self._wire_fell_back = False
        fetch = str(slv_config.get("flow_fetch_dtype", "float32"))
        if fetch not in FETCH_DTYPES:
            # a typo ("fp16") would otherwise fetch float32 while the
            # operator believes the bytes were halved
            raise ValueError(f"flow_fetch_dtype: unknown dtype {fetch!r} "
                             "(expected float32, float16 or bfloat16)")
        self._fetch_dtype = FETCH_DTYPES[fetch]
        if (self._fetch_dtype is not None
                and not type(self).SUPPORTS_FLOW_FETCH_DTYPE):
            raise ValueError(
                "flow_fetch_dtype: not supported by "
                f"{type(self).__name__} — only the serving-path solver "
                "(patch_eklt_pyramid2) implements the reduced-precision "
                "flow fetch")

    def _to_events(self, events, need_t: bool = True) -> Events:
        """Upload an ``(n, 4)`` event array to the solver's device in a
        power-of-two capacity (or pass :class:`Events` through).

        ``need_t=False`` lets a caller that never reads timestamps (the
        pyramid solve) take the t-less wire (5 B/event); the decoded
        timestamps are then zeros.
        """
        if isinstance(events, Events):
            return events
        arr = np.asarray(events)
        cap = bucket_capacity(len(arr))
        use_wire, wire_mode, opportunistic = (self.wire_quantized,
                                              self.wire_mode, False)
        if (not use_wire and self._wire_opportunistic
                and self.dtype == torch.float32 and arr.ndim == 2):
            use_wire, wire_mode, opportunistic = True, "exact", True
        if use_wire and self.dtype != torch.float32 and wire_mode == "exact":
            # the exact wire's contract is bit-equality at float32; a
            # float64 solver keeps the precision of the direct upload
            if not self._wire_fell_back:
                self._wire_fell_back = True
                logger.warning(
                    "quantized_upload (exact) is defined at float32; this "
                    "solver runs %s — using direct uploads ('round' mode "
                    "would keep the compact wire).",
                    str(self.dtype).replace("torch.", ""))
            use_wire = False
        if use_wire:
            with span("ebt.encode"):
                wire = encode_wire_events(arr, cap, include_t=need_t,
                                          mode=wire_mode,
                                          t_bitwise=opportunistic)
            if wire is not None:
                with span("ebt.upload"):
                    return decode_wire_events(wire, dtype=self.dtype,
                                              device=self.device)
            if not opportunistic and not self._wire_fell_back:
                self._wire_fell_back = True
                logger.warning(
                    "quantized_upload (%s): batch not representable on the "
                    "wire grid (%s) — falling back to float32 uploads.",
                    wire_mode,
                    "out-of-range values" if wire_mode == "round"
                    else "sub-1/32-px coordinates or out-of-range values; "
                         "'round' mode would snap them instead")
        with span("ebt.upload"):
            return events_from_ndarray(arr, capacity=cap, dtype=self.dtype,
                                       device=self.device)
