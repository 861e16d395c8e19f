"""Coordinator layer: the mean self time of the `coordinator` span (its
duration less its `fan_out` child's) over the traces in the ring at the
end of the unprofiled part of the window."""


def read(ctx):
    selfs = []
    for tr in ctx.get("traces") or []:
        spans = tr.get("spans", [])
        for s in spans:
            if s["name"] != "coordinator":
                continue
            child = sum(c["duration_ns"] for c in spans
                        if c.get("parent_id") == s["id"] and c["name"] == "fan_out")
            selfs.append((s["duration_ns"] - child) * 1e-6)
    return sum(selfs) / len(selfs) if selfs else None
