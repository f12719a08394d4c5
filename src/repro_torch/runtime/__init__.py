"""Runtime seams of the port: the clock (``telemetry``), fault handling
(``fault``: ``PreemptionGuard``, ``Preempted``, ``retriable``) and the
lossless int32 column codec (``compression``)."""
