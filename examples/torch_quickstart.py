"""Quickstart on the PyTorch port: the paper's Intelligent Resource Manager
in 60 seconds.

The port's counterpart of ``examples/quickstart.py``, through
``repro_torch``'s own copies of the numpy modules; it prints what that
example prints.  The three layers of the reproduction, end to end at toy
scale:

  1. the online bin-packing core (First-Fit over a pre-loaded cluster),
  2. the IRM scheduling a simulated streaming workload (paper Sec. VI-B),
  3. the same First-Fit engine packing documents into training rows.

Nothing here runs on the card: it is numpy.  The port's paths on the card
are the other ``examples/torch_*.py`` walkthroughs.

Usage:
  PYTHONPATH=src python examples/torch_quickstart.py
"""

import numpy as np

from repro_torch.core import FirstFit, Item, SimConfig, lower_bound, simulate
from repro_torch.data import pack_documents, packing_efficiency, synthetic_documents
from repro_torch.scenarios import get_scenario


def demo_binpacking() -> None:
    print("=" * 64)
    print("1. Online First-Fit bin-packing (paper Section IV)")
    print("=" * 64)
    sizes = [0.5, 0.7, 0.5, 0.2, 0.4, 0.2, 0.8, 0.3]
    result = FirstFit().pack([Item(s) for s in sizes])
    print(f"items: {sizes}")
    print(f"assignments (item -> worker): {result.assignments}")
    print(f"workers used: {result.num_bins} "
          f"(ideal lower bound: {lower_bound(sizes)})")
    for i, b in enumerate(result.bins):
        bar = "#" * int(b.used * 40)
        print(f"  worker {i}: [{bar:<40}] {b.used:.0%}")


def demo_irm_simulation() -> None:
    print()
    print("=" * 64)
    print("2. IRM scheduling the microscopy stream (paper Section VI-B)")
    print("=" * 64)
    stream = get_scenario("microscopy").make_stream(
        0, n_images=120, duration_range=(5.0, 10.0))
    res = simulate(
        stream,
        SimConfig(dt=0.5, cores_per_worker=8, max_workers=5,
                  worker_boot_delay=10.0, pe_start_delay=2.0, t_max=1200.0),
    )
    print(f"processed {res.completed}/{res.total} images "
          f"in {res.makespan:.0f}s (5-worker cap)")
    active = res.scheduled_cpu > 0.05
    print(f"mean scheduled utilization while active: "
          f"{res.scheduled_cpu[active].mean():.0%}")
    print(f"peak target workers requested by the IRM: "
          f"{res.target_workers.max()} (cap 5 — the IRM keeps asking, "
          f"paper Fig. 10)")
    err = res.error[active]
    print(f"scheduled-vs-measured error: mean {err.mean():+.1f}pp, "
          f"median |err| {np.median(np.abs(err)):.1f}pp (paper Fig. 9)")


def demo_sequence_packing() -> None:
    print()
    print("=" * 64)
    print("3. First-Fit sequence packing for training data (framework layer)")
    print("=" * 64)
    docs = list(synthetic_documents(50000, mean_len=700, seed=0, limit=500))
    batches = list(pack_documents(docs, seq_len=4096, batch_size=8))
    eff = packing_efficiency(batches)
    naive = sum(min(len(d), 4096) for d in docs) / (len(docs) * 4096)
    print(f"{len(docs)} documents -> {len(batches)} batches of 8x4096")
    print(f"packing efficiency: {eff:.1%} (one-doc-per-row baseline: "
          f"{naive:.1%})")
    print(f"rows saved vs padding: {1 - len(batches) * 8 / len(docs):.0%}")


if __name__ == "__main__":
    demo_binpacking()
    demo_irm_simulation()
    demo_sequence_packing()
    print("\nDone. Next: examples/torch_train_stream.py, "
          "examples/torch_serve_microscopy.py")
