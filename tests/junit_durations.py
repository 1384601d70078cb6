"""Test-seconds of pytest junit XML files, as PERF.md reports them.

    python tests/junit_durations.py RUN.xml [N]
    python tests/junit_durations.py BEFORE.xml AFTER.xml [N]

With one file: the total test-seconds, those of the port's files
(tests/test_torch_*.py) and of the rest, the N slowest tests (default
40, like --durations=40) and every file's sum, slowest first. With two:
the N slowest tests of the first with each one's seconds in the second
beside them, and both files' totals. Under pytest-xdist a test's seconds
are its worker's wall time, so they grow with the load of the other
workers.
"""
import collections
import sys
import xml.etree.ElementTree as ET


def read(path: str) -> dict:
    """{"file::test": seconds}."""
    return {f"{tc.get('classname')}::{tc.get('name')}":
            float(tc.get("time") or 0.0)
            for tc in ET.parse(path).getroot().iter("testcase")}


def totals(tests: dict) -> str:
    total = sum(tests.values())
    port = sum(v for k, v in tests.items() if ".test_torch_" in k)
    return (f"total {total:.1f} test-s: port {port:.1f}, the rest "
            f"{total - port:.1f}")


def main(paths, n: int = 40) -> None:
    runs = [read(p) for p in paths]
    for path, tests in zip(paths, runs):
        print(f"{path}: {totals(tests)}")
    slowest = sorted(runs[0].items(), key=lambda kv: -kv[1])[:n]
    print(f"\nslowest {n} tests of {paths[0]}")
    for name, secs in slowest:
        after = "" if len(runs) == 1 else \
            f"{runs[1].get(name, float('nan')):8.1f}"
        print(f"{secs:8.1f}{after}  {name}")
    if len(runs) == 1:
        files = collections.Counter()
        for name, secs in runs[0].items():
            files[name.split("::")[0]] += secs
        print("\nby file")
        for name, secs in files.most_common():
            print(f"{secs:8.1f}  {name}")


if __name__ == "__main__":
    args = sys.argv[1:]
    count = int(args.pop()) if args[-1].isdigit() else 40
    main(args, count)
