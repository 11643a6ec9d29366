"""Mean host time of one ``decode_fn`` call (``decode_step``): from the
end of each call's TTFT to the call's end, less its decode-side probes,
over its S re-prefill and ``max_new`` decode steps; both ends are
synchronised."""


def read(run):
    r = run.record
    calls = r.get("calls")
    if not calls:
        return None
    busy = sum(c["t_end"] - c["t_decode0"]
               - sum(s for kind, s in c["probe_s"] if kind == "decode")
               for c in calls)
    steps = sum(c["S"] + r["max_new"] for c in calls)
    return 1e3 * busy / steps
