"""Trace ingestion (a copy of the reference's numpy-only
``repro.data.ingest``) and the two sample scheduler logs it ships with,
copied byte for byte into ``sample_traces/`` beside this file; the
synthetic token pipeline of training (``pipeline``, also numpy only)."""
from pathlib import Path

from repro_torch.data.ingest import (TraceCalibration, TraceParseError,
                                     calibrate_generators,
                                     generate_calibrated, load_trace,
                                     read_csv_trace, read_jobs_info,
                                     read_jsonl_trace, read_nodes_info,
                                     write_jobs_info, write_nodes_info)
from repro_torch.data.pipeline import SyntheticTokenPipeline

SAMPLE_TRACES = Path(__file__).resolve().parent / "sample_traces"
