"""Share of the window spent in the token-by-token re-prefill: from the
end of each call's TTFT to the card finishing its ``decode_fn`` calls
with ``cur_len`` < S (a synchronisation there, in the traced run)."""


def read(run):
    r = run.record
    calls = r.get("calls")
    if not calls or any("reprefill_s" not in c for c in calls):
        return None
    return 100.0 * sum(c["reprefill_s"] for c in calls) / r["window_s"]
