"""The paper's §3.4 use case: analysing the connectivity of a connected
society — Neubot-style network-test streams, answered by the paper's three
queries, each a StreamService fusing store history with the live stream.

    Q1: EVERY 60 s  max(download_speed) of the last 3 minutes
    Q2: EVERY 5 min mean(download_speed) of the last 120 days (history!)
    Q3: EVERY 30 s  mean(upload_speed) starting 10 days ago (landmark)

Stores live on the "VDC" (backend); the live stream and the services run
on the edge; the BufferManager spills to the VDC store when edge RAM runs
out — the full §3.1–3.2 data management story.

    PYTHONPATH=src python examples/streaming_pipeline.py
"""

import numpy as np

from repro_torch.data import (Fetch, HistoricFetch, MessageBroker, NeubotStream,
                        Sink, StreamService, TimeSeriesStore)

DAY = 86400.0


def main() -> None:
    broker = MessageBroker()
    vdc_store = TimeSeriesStore(location="backend")

    # 120 days of history in the VDC store (compressed time for the demo:
    # hourly aggregates)
    src = NeubotStream(n_providers=3, rate_hz=1 / 3600.0, seed=7)
    hist = src.batch(n=120 * 24, t0=0.0)
    vdc_store.write("speedtests", hist)
    t_now = float(hist.ts[-1])
    print(f"history: {len(hist)} tuples covering "
          f"{(t_now - float(hist.ts[0])) / DAY:.0f} days "
          f"({vdc_store.nbytes('speedtests') / 1e3:.0f} kB in the VDC store)")

    q1 = StreamService("q1_max_down_3min",
                       Fetch(broker, "neubotspeed", "q1"), Sink(),
                       period=60.0, window=180.0, agg="max",
                       column="download_speed")
    q2 = StreamService("q2_mean_down_120d",
                       Fetch(broker, "neubotspeed", "q2"), Sink(),
                       period=300.0, window=120 * DAY, agg="mean",
                       column="download_speed",
                       historic=HistoricFetch(vdc_store, "speedtests"))
    q3 = StreamService("q3_mean_up_since_10d",
                       Fetch(broker, "neubotspeed", "q3"), Sink(),
                       period=30.0, window=1e18, agg="mean",
                       column="upload_speed",
                       historic=HistoricFetch(vdc_store, "speedtests"),
                       landmark=t_now - 10 * DAY)

    # live edge stream: ~1 test/2 s for 20 minutes
    live = NeubotStream(n_providers=3, rate_hz=0.5, seed=8)
    services = (q1, q2, q3)
    for batch in live.stream(batch_size=60, n_batches=10):
        shifted = batch
        shifted.ts[:] = shifted.ts + t_now          # live continues history
        broker.publish("neubotspeed", shifted)
        t = float(shifted.ts[-1])
        for svc in services:
            svc.step(t)

    for svc in services:
        if svc.sink.collected:
            t_last, v_last = svc.sink.collected[-1]
            print(f"{svc.name:<24} fired {svc.fired:>3}×  "
                  f"last = {float(np.ravel(v_last)[0]):8.2f} Mbps")
        else:
            print(f"{svc.name:<24} (not yet due)")
    assert q1.fired > 0 and q3.fired > 0
    print("streaming pipeline OK")


if __name__ == "__main__":
    main()
