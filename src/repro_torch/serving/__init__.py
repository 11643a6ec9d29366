"""PD-disaggregated serving runtime: paged KV, prefill/decode engines, the
Mooncake-style KV transfer link, and the event-driven cluster simulator."""
