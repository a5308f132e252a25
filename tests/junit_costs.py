"""Per-file cost of a pytest run, from its junit XML.

junit's ``time`` of a case holds its setup, call and teardown, so a module
fixture's cost lands on the first case that uses it. Under ``--dist
loadfile`` a file runs whole on one worker, so a file's summed time is what
it holds that worker for.

    python tests/junit_costs.py run.xml                 # every file, largest first
    python tests/junit_costs.py run.xml --compare other.xml   # two runs side by side

The last lines give the totals of the port's files (``test_torch_*``) and
of the rest."""

import argparse
import collections
import xml.etree.ElementTree as ET


def file_costs(path):
    """{file: [summed seconds, cases, passed]} of one junit file."""
    out = collections.defaultdict(lambda: [0.0, 0, 0])
    for case in ET.parse(path).getroot().iter("testcase"):
        # classname is "tests.test_x" (or "tests.test_x.TestClass")
        parts = case.get("classname", "?").split(".")
        name = next((p for p in parts if p.startswith("test_")), parts[-1])
        row = out[name]
        row[0] += float(case.get("time", 0.0))
        row[1] += 1
        row[2] += not any(c.tag in ("failure", "error", "skipped") for c in case)
    return dict(out)


def _totals(costs):
    port = [v for k, v in costs.items() if k.startswith("test_torch_")]
    rest = [v for k, v in costs.items() if not k.startswith("test_torch_")]
    return ((sum(v[0] for v in port), sum(v[1] for v in port)),
            (sum(v[0] for v in rest), sum(v[1] for v in rest)),
            sum(v[2] for v in costs.values()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--compare", help="a second junit file, printed beside the first")
    ap.add_argument("--port", action="store_true", help="the port's files only")
    args = ap.parse_args(argv)
    runs = [file_costs(args.xml)] + ([file_costs(args.compare)] if args.compare else [])
    names = sorted(set().union(*runs), key=lambda k: -max(r.get(k, [0])[0] for r in runs))
    if args.port:
        names = [k for k in names if k.startswith("test_torch_")]
    for k in names:
        cells = "".join(f"{r[k][0]:10.1f} {r[k][1]:5d}" if k in r else f"{'-':>10} {'-':>5}"
                        for r in runs)
        print(f"{k:40s}{cells}")
    for label, i in (("port (test_torch_*)", 0), ("the rest", 1)):
        print(f"{label:40s}" + "".join(f"{_totals(r)[i][0]:10.1f} {_totals(r)[i][1]:5d}"
                                       for r in runs))
    print(f"{'passed':40s}" + "".join(f"{_totals(r)[2]:16d}" for r in runs))


if __name__ == "__main__":
    main()
