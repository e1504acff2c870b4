"""Before and after of chip_smoke.py's kernel rows: reads the output files of
runs of ``chip_smoke.py --phases build,kernels`` on two trees in one call
(parent, change, change, parent), matches the rows of their ``kernels``
lines by kernel name and shape, and prints, per row, the parent's and the
change's ms (each the mean of its runs), the change over the parent, and,
where the change's row carries its twin without mins (``no_mins_ms``), the
change over that twin; a row's runs that disagree by more than `spread`
are marked.  The card line (``nvidia-smi`` name and power limit) of each
run is printed first.  Reads files only; needs no card.

    python -m booster_tpu_torch.tools.ab_rows --parent p1.txt p2.txt --change c1.txt c2.txt \\
        [--match SUBSTRING ...] [--json]
"""

from __future__ import annotations

import argparse
import json
import statistics


def rows_of(path: str) -> tuple[str, dict]:
    """(the card line, {(name, shape): row}) of one chip_smoke.py output."""
    card, rows = "", {}
    with open(path) as f:
        for line in f:
            if line.startswith("{\"kernels\""):
                rows = {(r["name"], r["shape"]): r for r in json.loads(line)["kernels"]}
            elif "," in line and line.strip().endswith(" W") and not line.startswith("{"):
                card = line.strip()
    return card, rows


def compare(parent: list, change: list, match: list, spread: float = 0.05) -> list:
    """One dict a row of the change's runs found in the parent's runs."""
    p_runs = [rows_of(f) for f in parent]
    c_runs = [rows_of(f) for f in change]
    out = []
    for key, row in c_runs[0][1].items():
        if match and not any(m in f"{key[0]} {key[1]}" for m in match):
            continue
        pm = [r[key]["ms"] for _, r in p_runs if key in r]
        cm = [r[key]["ms"] for _, r in c_runs if key in r]
        if not pm or not cm:
            continue
        twin = [r[key].get("no_mins_ms") for _, r in c_runs if key in r]
        twin = [t for t in twin if t is not None]
        p, c = statistics.mean(pm), statistics.mean(cm)
        d = {"name": key[0], "shape": key[1], "parent_ms": pm, "change_ms": cm,
             "after_over_before": c / p}
        if twin:
            d["no_mins_ms"] = twin
            d["after_over_twin"] = c / statistics.mean(twin)
        d["noisy"] = max(pm) > (1 + spread) * min(pm) or max(cm) > (1 + spread) * min(cm)
        out.append(d)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", nargs="+", required=True)
    ap.add_argument("--change", nargs="+", required=True)
    ap.add_argument("--match", nargs="*", default=[])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    for f in args.parent + args.change:
        print(f"{f}: {rows_of(f)[0]}")
    res = compare(args.parent, args.change, args.match)
    for d in res:
        if args.json:
            print(json.dumps(d))
            continue
        twin = f" twin {d['after_over_twin']:.3f}x" if "after_over_twin" in d else ""
        print(f"{d['name']} | {d['shape']} | {statistics.mean(d['parent_ms']):.5f} -> "
              f"{statistics.mean(d['change_ms']):.5f} ms | {d['after_over_before']:.3f}x{twin}"
              + (" | noisy" if d["noisy"] else ""))
    return res


if __name__ == "__main__":
    main()
