"""Paper §3.1 / Fig. 2: the three vector-search placement architectures.

Each placement yields (i) the retrieval RTT seen by prefill / decode
instances and (ii) side-effects on the LLM pools themselves. Constants are
derived from the Hardware model with the napkin math inline (all quantities
per retrieval or per step; see bench_architectures for the full study).

 (a) coupled      — vector chip inside every P/D server: intra-node ICI RTT
                    for retrieval, BUT one chip per server is lost to the
                    EP/TP group → displaced experts go inter-node (decode
                    dispatch/combine pays a DCN hop) and LLM capacity
                    shrinks by 1/chips_per_node.
 (b) prefill-coloc — vector chips co-located with prefill only: prefill
                    retrieval over ICI, decode over DCN; prefill keeps
                    paying its TP collectives on the critical path (the
                    saved µs don't compound), and prefill loses capacity.
 (c) disaggregated — independent pool (Trinity): both stages pay a DCN RTT;
                    no capacity loss, no contention.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.roofline_model import V5E, Hardware


@dataclasses.dataclass(frozen=True)
class Placement:
    name: str
    prefill_rtt: float  # retrieval network RTT from prefill instance
    decode_rtt: float  # retrieval network RTT from decode instance
    llm_capacity_factor_prefill: float  # usable chip fraction, prefill pool
    llm_capacity_factor_decode: float
    ep_dispatch_penalty: float  # extra per-decode-step latency (EP displaced)
    hbm_contention_factor: float  # >1: vector search shares node HBM/ICI


def make_placements(hw: Hardware = V5E, chips_per_node: int = 8):
    """The Fig. 2 trio with napkin-math constants.

    EP displacement (a): 1/chips_per_node of experts move off-node; each
    decode step's dispatch+combine for that share crosses DCN instead of
    ICI: penalty ≈ 2 · (expert payload/DCN − expert payload/ICI) for the
    displaced fraction. With ~1 MB payload/step/chip and 1/8 displaced:
    2·(1 MB/6.25 GB/s − 1 MB/50 GB/s)/8 ≈ 35 µs.
    """
    ici_rtt = 2 * hw.intra_node_lat
    dcn_rtt = 2 * hw.network_lat
    payload = 1.0e6  # bytes of EP dispatch+combine per step per chip
    displaced = 1.0 / chips_per_node
    ep_pen = 2 * displaced * (payload / hw.dcn_bw - payload / hw.ici_bw)
    cap = 1.0 - 1.0 / chips_per_node
    return {
        "coupled": Placement("coupled", ici_rtt, ici_rtt, cap, cap,
                             ep_pen, 1.15),
        "prefill_coloc": Placement("prefill_coloc", ici_rtt, dcn_rtt, cap,
                                   1.0, 0.0, 1.05),
        "disaggregated": Placement("disaggregated", dcn_rtt, dcn_rtt, 1.0,
                                   1.0, 0.0, 1.0),
    }
