"""Summarise a jax.profiler trace: per-line event totals of every GPU device
plane, then the top operations of the busiest line (or of the line named).

    python tools/parse_xplane.py <trace_dir> [line_name]
"""
import collections
import glob
import sys

from jax.profiler import ProfileData


def main(root, want_line=None):
    for path in glob.glob(root + "/**/*.xplane.pb", recursive=True):
        data = ProfileData.from_file(path)
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            print(f"== plane {plane.name}")
            best, best_n = None, -1
            for line in plane.lines:
                events = list(line.events)
                tot = sum(e.duration_ns for e in events) / 1e6
                print(f"  line '{line.name}': {len(events)} events, {tot:.3f} ms")
                if want_line and line.name == want_line:
                    best = events
                elif not want_line and len(events) > best_n:
                    best, best_n = events, len(events)
            if not best:
                continue
            agg, cnt = collections.Counter(), collections.Counter()
            for ev in best:
                agg[ev.name] += ev.duration_ns / 1e6
                cnt[ev.name] += 1
            print(f"   total {sum(agg.values()):.3f} ms")
            for name, ms in agg.most_common(45):
                print(f"  {ms:9.3f} ms  x{cnt[name]:5d}  {name[:130]}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
