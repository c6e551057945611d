"""The paper's Data-Science workload (Fig. 5) with the port's backends.

The 16-node DAG of "frequently used data science functions such as SQL
Transform, data summarization, column selection in dataset, filter-based
feature selection, k-means clustering, time series anomaly detection, sweep
clustering, train clustering model etc.", laid out as the reference package
lays it out (ETL prefix → parallel analytics branches → join/export), with

  * ``work`` — calibrated work units (see repro_torch.core.cost_model.RATE);
  * ``in_bytes`` — raw sensor volume pulled by the source;
  * ``out_bytes`` — inter-task volumes, decreasing along the ETL prefix.

Below them, copies of the reference module's other builders (a neubot
query, an LM training job, one LM inference request), unchanged.
"""

from __future__ import annotations

from repro_torch.core.dag import PipelineDAG, Task

MB = 1e6

#: (op, work, out_bytes); work units calibrated jointly with the RATE table
#: so the emulation reproduces the paper's reported aggregates.
_NODES = [
    ("ingest", 4.0, 16 * MB),
    ("sql_transform", 4.0, 8 * MB),
    ("clean_missing", 4.0, 6 * MB),
    ("select_columns", 2.0, 2 * MB),
    ("summarize", 8.0, 0.2 * MB),
    ("window_agg", 8.0, 1 * MB),
    ("anomaly", 8.0, 0.2 * MB),
    ("filter_features", 4.0, 1 * MB),
    ("pca", 4.8, 0.5 * MB),
    ("kmeans", 16.0, 0.5 * MB),
    ("sweep_clustering", 19.2, 0.5 * MB),
    ("train_cluster", 16.0, 0.5 * MB),
    ("linreg", 4.0, 0.2 * MB),
    ("score", 8.0, 0.2 * MB),
    ("join", 2.0, 0.5 * MB),
    ("export", 1.0, 0.0),
]

_EDGES = [
    ("ingest", "sql_transform"),
    ("sql_transform", "clean_missing"),
    ("clean_missing", "select_columns"),
    ("select_columns", "summarize"),
    ("select_columns", "window_agg"),
    ("window_agg", "anomaly"),
    ("select_columns", "filter_features"),
    ("filter_features", "pca"),
    ("filter_features", "kmeans"),
    ("pca", "sweep_clustering"),
    ("pca", "linreg"),
    ("kmeans", "train_cluster"),
    ("sweep_clustering", "train_cluster"),
    ("train_cluster", "score"),
    ("linreg", "score"),
    ("summarize", "join"),
    ("anomaly", "join"),
    ("score", "join"),
    ("join", "export"),
]


def ds_workload(raw_mb: float = 16.0, work_scale: float = 1.0) -> PipelineDAG:
    """Build the paper's 16-task DS workload DAG."""
    g = PipelineDAG("ds_workload")
    for op, work, out in _NODES:
        in_bytes = raw_mb * MB if op == "ingest" else 0.0
        out_bytes = out if op != "ingest" else raw_mb * MB
        g.add_task(
            Task(
                name=op,
                op=op,
                work=work * work_scale,
                out_bytes=out_bytes,
                in_bytes=in_bytes,
            )
        )
    for a, b in _EDGES:
        g.add_edge(a, b)
    assert len(g) == 16, "paper's workload has 16 task nodes"
    return g


def ds_workload_executable(raw_mb: float = 16.0) -> PipelineDAG:
    """The 16-task workload with host and device backends attached.

    Each node's backend consumes its predecessors' outputs in edge order and
    forwards what successors need:

        ingest → sql_transform → clean_missing → select_columns
        select_columns → {summarize, window_agg→anomaly, filter_features}
        filter_features → {pca, kmeans}
        pca → {sweep_clustering, linreg}; {kmeans, sweep}→train_cluster
        {train_cluster, linreg}→score; {summarize, anomaly, score}→join→export

    The executor moves every input to the side its task runs on, so the
    binders here take no device.
    """
    from repro_torch.pipeline.operators import device_backend, host_backend

    g = ds_workload(raw_mb=raw_mb)
    for side, op_of in (("host", host_backend), ("device", device_backend)):
        ops = {op: op_of(op) for op, _, _ in _NODES}
        fns = {
            "ingest": ops["ingest"],
            "sql_transform": ops["sql_transform"],
            "clean_missing": ops["clean_missing"],
            "select_columns": lambda x, ops=ops: ops["select_columns"](x, k=4),
            "summarize": ops["summarize"],
            "window_agg": lambda x, ops=ops: ops["window_agg"](x, window=8),
            "anomaly": lambda wa, ops=ops: ops["anomaly"](wa, window=16),
            "filter_features": lambda x, ops=ops: {
                "x": ops["filter_features"](x, k=3)
            },
            "pca": lambda ff, ops=ops: {"x": ops["pca"](ff["x"], k=2)},
            "kmeans": lambda ff, ops=ops: {
                "x": ff["x"],
                "fit": ops["kmeans"](ff["x"], k=4),
            },
            "sweep_clustering": lambda pc, ops=ops: {
                "x": pc["x"],
                "fit": ops["sweep_clustering"](pc["x"]),
            },
            "train_cluster": lambda km, sw, ops=ops: {
                "x": km["x"],
                "fit": ops["train_cluster"](km["x"], km["fit"][0]),
            },
            "linreg": lambda pc, ops=ops: {
                "x": pc["x"],
                "model": ops["linreg"](pc["x"]),
            },
            "score": lambda tc, lr, ops=ops: ops["score"](
                lr["x"], lr["model"][0], lr["model"][1]
            ),
            "join": lambda s, an, sc, ops=ops: ops["join"](s, an, sc[0]),
            "export": ops["export"],
        }
        for name, fn in fns.items():  # det: ok binds each task once; order irrelevant
            g.task(name).backends[side] = fn
    return g


def neubot_query_pipeline(query: str = "max_download_3min",
                          raw_mb: float = 4.0) -> PipelineDAG:
    """A neubot-style streaming query (paper §3.4) as a mini-DAG.

    EVERY <rate> compute <agg> of <metric> over <window>
    FROM <store> and streaming <queue>
    """
    g = PipelineDAG(f"neubot_{query}")
    g.add_task(Task("fetch_stream", "ingest", work=1.0, out_bytes=0.5 * MB,
                    in_bytes=raw_mb * MB))
    g.add_task(Task("historic_fetch", "ingest", work=2.0, out_bytes=2 * MB))
    g.add_task(Task("window", "window_agg", work=4.0, out_bytes=0.5 * MB))
    g.add_task(Task("aggregate", "summarize", work=4.0, out_bytes=0.1 * MB))
    g.add_task(Task("sink", "export", work=0.5, out_bytes=0.0))
    g.add_edge("fetch_stream", "window")
    g.add_edge("historic_fetch", "window")
    g.add_edge("window", "aggregate")
    g.add_edge("aggregate", "sink")
    return g


def lm_training_pipeline(arch: str, steps_work: float = 1000.0,
                         tokens_mb: float = 64.0) -> PipelineDAG:
    """An LM training job as a JITA pipeline: host-side data pipeline tasks
    ("edge") feeding device train steps ("VDC") — how the assigned
    architectures enter the JITA-4DS scheduling world."""
    g = PipelineDAG(f"lm_{arch}")
    g.add_task(Task("fetch_corpus", "ingest", work=2.0,
                    out_bytes=tokens_mb * MB, in_bytes=tokens_mb * MB))
    g.add_task(Task("tokenize", "sql_transform", work=8.0,
                    out_bytes=tokens_mb / 4 * MB))
    g.add_task(Task("pack_batches", "select_columns", work=4.0,
                    out_bytes=tokens_mb / 4 * MB))
    g.add_task(Task("train", "lm_train_step", work=steps_work,
                    out_bytes=1 * MB, params={"arch": arch}))
    g.add_task(Task("eval", "lm_prefill", work=steps_work / 10,
                    out_bytes=0.1 * MB))
    g.add_task(Task("checkpoint", "export", work=1.0, out_bytes=0.0))
    g.chain("fetch_corpus", "tokenize", "pack_batches", "train", "eval",
            "checkpoint")
    return g


def inference_request_pipeline(rid: int, prompt_tokens: int,
                               decode_tokens: int, *,
                               prefill_work_per_tok: float = 1.0,
                               decode_work_per_tok: float = 5.0,
                               kv_bytes_per_tok: float = 0.0) -> PipelineDAG:
    """One LM inference request as a JITA pipeline: a prefill task feeding
    a decode task, names suffixed ``#<rid>`` so the request is a pipeline
    *instance* (instance id ``str(rid)``) that carries its own
    :class:`~repro.core.vos.ValueCurve` through the online driver — the
    request→DAG mapping of the serving gateway
    (:mod:`repro.serve.gateway`). Work is per-token cost × token count;
    the gateway's cost-model bridge picks the per-token costs so engine
    exec time equals the serve engine's abstract per-token clock."""
    g = PipelineDAG(f"req{rid}")
    g.add_task(Task(f"prefill#{rid}", "lm_prefill",
                    work=prompt_tokens * prefill_work_per_tok,
                    out_bytes=prompt_tokens * kv_bytes_per_tok))
    g.add_task(Task(f"decode#{rid}", "lm_decode",
                    work=decode_tokens * decode_work_per_tok,
                    out_bytes=0.0))
    g.add_edge(f"prefill#{rid}", f"decode#{rid}")
    return g
