"""Generate docs/API.md — an auto-built index of the public surface.

Run: python scripts/gen_api_docs.py   (forces the CPU backend; safe to
run anywhere).  One line per public symbol: signature + first docstring
line, grouped by subsystem.
"""
import inspect
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

SECTIONS = [
    ("Top-level solvers & API", "pyamg_tpu"),
    ("Classical AMG (Ruge-Stuben, AIR, CR)", "pyamg_tpu.classical"),
    ("Aggregation AMG (SA, rootnode, adaptive, pairwise)",
     "pyamg_tpu.aggregation"),
    ("Relaxation / smoothers", "pyamg_tpu.relaxation"),
    ("Krylov solvers", "pyamg_tpu.krylov"),
    ("Strength of connection", "pyamg_tpu.strength"),
    ("Graph algorithms", "pyamg_tpu.graph"),
    ("Linear-algebra utilities", "pyamg_tpu.util.linalg"),
    ("General utilities", "pyamg_tpu.util.utils"),
    ("Checkpointing", "pyamg_tpu.util.serialize"),
    ("Gallery (test problems)", "pyamg_tpu.gallery"),
    ("Blackbox API", "pyamg_tpu.blackbox"),
    ("Device engine (device hierarchies, device setup, device Krylov)",
     "pyamg_tpu.engine"),
    ("Device sparse formats & kernels", "pyamg_tpu.sparse"),
    ("Distributed (GSPMD sharding, halo SpMV, multihost)",
     "pyamg_tpu.parallel"),
    ("Visualization", "pyamg_tpu.vis"),
]


def main(out_path):
    lines = ["# pyamg_tpu API reference", "",
             "Auto-generated index of the public surface (one-line "
             "summaries from docstrings).",
             "Regenerate with `python scripts/gen_api_docs.py`."]
    for title, m in SECTIONS:
        mod = importlib.import_module(m)
        names = getattr(mod, "__all__", None) or sorted(
            n for n in dir(mod) if not n.startswith("_"))
        lines += ["", f"## {title} — `{m}`", ""]
        for n in sorted(names):
            obj = getattr(mod, n, None)
            if obj is None or inspect.ismodule(obj):
                continue
            doc = (inspect.getdoc(obj) or "").strip().split("\n")[0]
            kind = ("class" if inspect.isclass(obj) else
                    "fn" if callable(obj) else "obj")
            try:
                sig = str(inspect.signature(obj)) if callable(obj) else ""
                if len(sig) > 80:
                    sig = sig[:77] + "..."
            except (ValueError, TypeError):
                sig = ""
            sig_md = f"`{sig}`" if sig else ""
            lines.append(f"- **`{n}`**{sig_md} ({kind}) — {doc}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_path} ({len(lines)} lines)")


if __name__ == "__main__":
    main(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "API.md"))
