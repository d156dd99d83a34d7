"""Share of the ranked query rows that the top-k certificate sent to a
dense re-rank, in the traced slice: 100 x (``topk.repaired_rows`` +
``topk.fallback_rows``) / ``topk.rows``, the program's counters."""

from port_bench import spans


def read(r):
    c = spans.program_counts()
    if not c.get("topk.rows"):
        return None
    return 100.0 * (c.get("topk.repaired_rows", 0)
                    + c.get("topk.fallback_rows", 0)) / c["topk.rows"]
