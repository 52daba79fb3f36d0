"""Synthetic workload generators calibrated to the paper's six workflows.

The paper measured private runs of six nf-core(-style) workflows on an
8-node cluster. Offline here, we generate seeded synthetic traces matching
the published statistics:

  * Table I    — task-type counts and average instances per type;
  * Fig. 1     — per-type peak-memory distributions (hundreds of MB .. GBs,
                 strong spread between executions of one type);
  * Fig. 2     — heterogeneous memory ~ input relationships: some types are
                 cleanly linear (MarkDuplicates), others are clustered and
                 defeat a single linear model (BaseRecalibrator);
  * Fig. 7     — workflows differ in overall memory/CPU/I-O weight;
  * Table II   — wastage magnitudes per workflow (runtime / preset scales).

Every draw comes from a numpy Generator seeded per (workflow, task type), so
traces are bit-reproducible and versioned by GENERATOR_VERSION.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.utils.misc import stable_hash
from repro_torch.workflow.dag import WorkflowDAG
from repro_torch.workflow.trace import TaskInstance, WorkflowTrace

GENERATOR_VERSION = 3

# memory ~ input relationship families observed in Fig. 1/2
REL_FAMILIES = ("linear", "clustered", "quadratic", "sqrt", "constant", "step")

# the standard resource ladder workflow developers pick presets from
PRESET_LADDER_GB = (0.5, 1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)

# memory-over-time shape families (KS+ / Bader et al.: tasks ramp, hold a
# working-set plateau, or spike late — a constant peak reservation
# over-reserves for most of the runtime in all but the flat case)
CURVE_SHAPES = ("ramp", "plateau", "spike", "flat")


def _usage_curve(shape: str, rng: np.random.Generator, peak_gb: float,
                 n_points: int = 8) -> tuple[tuple[float, float], ...]:
    """One piecewise-constant usage curve, normalized so max == peak_gb.

    Noise is heteroscedastic: its scale grows with the level (busy phases
    fluctuate more than idle ones), matching time-resolved traces.
    """
    grid = (np.arange(n_points) + 1.0) / n_points   # segment end fractions
    mids = grid - 0.5 / n_points
    if shape == "ramp":
        start = rng.uniform(0.15, 0.45)
        gamma = rng.uniform(0.7, 1.6)
        level = start + (1.0 - start) * mids ** gamma
    elif shape == "plateau":
        rise = rng.uniform(0.1, 0.3)
        fall = rng.uniform(0.0, 0.2)
        tail = rng.uniform(0.4, 0.8)
        level = np.ones(n_points)
        level[mids < rise] = 0.3 + 0.7 * mids[mids < rise] / rise
        late = mids > 1.0 - fall if fall > 0 else np.zeros(n_points, bool)
        level[late] = tail
    elif shape == "spike":
        base = rng.uniform(0.2, 0.5)
        width = rng.uniform(0.1, 0.25)
        center = rng.uniform(0.3, 0.9)
        level = np.full(n_points, base)
        level[np.abs(mids - center) <= width / 2] = 1.0
        level[int(np.argmin(np.abs(mids - center)))] = 1.0  # spike >= 1 cell
    elif shape == "flat":
        level = np.ones(n_points)
    else:
        raise ValueError(f"unknown curve shape {shape!r}")
    # heteroscedastic noise, then renormalize so the max is exactly 1
    level = np.clip(level * (1.0 + rng.normal(0, 0.05, n_points) * level),
                    0.05, None)
    level = level / level.max()
    return tuple((float(g), float(l * peak_gb))
                 for g, l in zip(grid, level))


@dataclasses.dataclass(frozen=True)
class WorkflowSpec:
    """Calibration of one experimental workflow (paper Table I / Fig. 7)."""
    name: str
    n_task_types: int
    avg_instances: int          # Table I
    mem_base_gb: tuple[float, float]    # range of per-type base memory
    mem_span: float             # how strongly memory scales with input
    input_gb: tuple[float, float]       # lognormal-ish input size range
    runtime_h: tuple[float, float]      # per-type mean runtime range
    rel_mix: tuple[str, ...]    # relationship families, cycled over types
    named_types: tuple[str, ...] = ()
    # how far above the worst observed case the developer presets sit
    # (Table II: preset wastage is 3x..40x Sizey's depending on workflow)
    preset_factor: float = 2.0


WORKFLOWS: dict[str, WorkflowSpec] = {
    # ancient-genome reconstruction: mid-size mem, hour-scale tasks
    "eager": WorkflowSpec(
        "eager", 13, 121, (0.4, 6.0), 2.5, (0.2, 8.0), (0.3, 1.5),
        ("linear", "clustered", "sqrt", "linear", "constant", "step"),
        ("adapter_removal", "bwa_align", "dedup", "damageprofiler"),
        preset_factor=1.6),
    # methylation calling: heavy I/O + heavy memory (largest preset waste)
    "methylseq": WorkflowSpec(
        "methylseq", 9, 100, (2.0, 14.0), 3.0, (0.5, 20.0), (0.8, 3.0),
        ("linear", "quadratic", "clustered", "linear", "sqrt"),
        ("bismark_align", "methylation_extract", "deduplicate"),
        preset_factor=7.0),
    # ChIP-seq: many small task types
    "chipseq": WorkflowSpec(
        "chipseq", 30, 82, (0.2, 3.0), 1.5, (0.05, 3.0), (0.05, 0.4),
        ("linear", "constant", "sqrt", "clustered", "linear", "step"),
        ("macs2_callpeak", "picard_markdup", "bwa_mem"),
        preset_factor=1.7),
    # RNA-seq: many types, few instances each (hardest online case)
    "rnaseq": WorkflowSpec(
        "rnaseq", 30, 39, (0.3, 4.0), 2.0, (0.1, 4.0), (0.05, 0.5),
        ("linear", "clustered", "quadratic", "constant", "sqrt", "linear"),
        ("fastqc", "markduplicates", "baserecalibrator", "star_align",
         "salmon_quant"),
        preset_factor=7.0),
    # metagenome assembly: few types, hundreds of instances, small-ish
    # tasks; prokka (the paper's Fig. 12 example) gets the input-regime
    # "clustered" family so the online-learning error decay is visible
    "mag": WorkflowSpec(
        "mag", 8, 720, (0.5, 5.0), 2.0, (0.1, 6.0), (0.05, 0.3),
        ("clustered", "linear", "sqrt", "linear", "step"),
        ("prokka", "megahit", "bowtie2", "checkm"),
        preset_factor=2.5),
    # remote sensing (images): tiny fast tasks, sub-GB memory
    "iwd": WorkflowSpec(
        "iwd", 5, 332, (0.15, 0.6), 0.8, (0.01, 0.4), (0.01, 0.06),
        ("linear", "constant", "sqrt", "clustered", "linear"),
        ("tile_extract", "graph_build", "watershed"),
        preset_factor=8.0),
}


def _type_names(spec: WorkflowSpec) -> list[str]:
    names = list(spec.named_types)[: spec.n_task_types]
    for i in range(len(names), spec.n_task_types):
        names.append(f"{spec.name}_t{i:02d}")
    return names


def _mem_fn(rel: str, rng: np.random.Generator, base: float, span: float,
            in_hi: float):
    """Return f(input_gb, rng) -> peak_gb for one task type."""
    slope = span * rng.uniform(0.5, 1.5) / max(in_hi, 1e-6)
    noise = rng.uniform(0.02, 0.10)  # relative noise

    if rel == "linear":
        return lambda x, r: base + slope * x + r.normal(0, noise * base)
    if rel == "sqrt":
        c = span * rng.uniform(0.5, 1.5) / max(np.sqrt(in_hi), 1e-6)
        return lambda x, r: base + c * np.sqrt(x) + r.normal(0, noise * base)
    if rel == "quadratic":
        c = 3.0 * span * rng.uniform(0.8, 1.6) / max(in_hi ** 2, 1e-6)
        return lambda x, r: base + c * x * x + r.normal(0, noise * base)
    if rel == "constant":
        return lambda x, r: base * (1.0 + r.normal(0, 2.5 * noise))
    if rel == "step":
        # tool allocates buffers in discrete chunks of the input
        chunk = in_hi / rng.integers(3, 6)
        c = span * rng.uniform(0.5, 1.2) / max(in_hi, 1e-6) * chunk
        return lambda x, r: (base + c * np.ceil(x / chunk)
                             + r.normal(0, noise * base))
    if rel == "clustered":
        # BaseRecalibrator-like (Fig. 2 right): the input space splits into
        # regimes with very different memory bands. The regime is a
        # *deterministic, non-linear* function of the input (e.g. reference
        # chunking), so k-NN / forest models can learn it while a single
        # linear model provably cannot (half its predictions fail or double-
        # waste — exactly the paper's motivating example).
        period = in_hi / rng.uniform(2.0, 4.0)
        hi_gain = rng.uniform(1.8, 3.0)
        return lambda x, r: ((base + slope * x) *
                             (hi_gain if int(np.floor(x / period)) % 2 == 1
                              else 1.0)
                             + r.normal(0, noise * base))
    raise ValueError(f"unknown relationship {rel!r}")


def _preset_for(max_actual: float, factor: float) -> float:
    """Workflow developers pick the smallest ladder step >= factor x the worst
    case they ever saw — presets never fail (paper Fig. 8c) but overprovision
    heavily (Fig. 8a: ~17x Sizey's wastage overall)."""
    target = max_actual * factor
    for p in PRESET_LADDER_GB:
        if p >= target:
            return float(p)
    return float(PRESET_LADDER_GB[-1])


def generate_workflow(name: str | None = None, seed: int = 0,
                      scale: float = 1.0,
                      machines: tuple[str, ...] = ("epyc128",),
                      machine_cap_gb: float = 128.0,
                      machine_caps_gb: dict[str, float] | None = None,
                      arrival_rate_per_h: float | None = None,
                      arrival_cv: float | None = None,
                      fan_in: int = 2,
                      usage_curves: bool = True,
                      curve_shapes: tuple[str, ...] = CURVE_SHAPES,
                      spec: WorkflowSpec | None = None
                      ) -> WorkflowTrace:
    """Generate the full trace for one workflow. ``scale`` shrinks instance
    counts for fast tests (tests use scale=0.1; benchmarks use 1.0).

    Every instance carries per-instance dependency edges expanded from the
    type-level DAG (scatter/gather, ``fan_in`` upstream shards), so the
    event-driven cluster engine can unlock ready sets as upstream
    instances complete. ``arrival_rate_per_h`` additionally gives the
    *root* instances (no upstream edges) a Poisson arrival process with
    that rate — the open-system load model; by default all roots are
    available at t=0 (closed-system replay, the serial simulator's view).

    ``machine_caps_gb`` emits a *heterogeneous* trace: a mapping of
    machine-class label -> memory capacity (e.g. ``{"m16": 16, "m32": 32,
    "m64": 64}``, matching :func:`repro.workflow.cluster.node_specs_from_caps`
    labels). Task types cycle over the classes, each instance carries its
    class's ``machine_cap_gb``, per-type peaks are clipped to the class
    capacity, and the trace-wide ``machine_cap_gb`` becomes the largest
    class — so per-machine predictor pools really see different
    capacities.

    ``usage_curves`` (default on) emits a per-task memory-over-time curve
    (``TaskInstance.usage_curve``): each task type draws a shape family
    from ``curve_shapes`` (ramp / plateau / spike / flat) and every
    instance gets a noisy piecewise-constant realization whose max is
    exactly its ``actual_peak_gb``. Curves come from a SEPARATE seeded rng
    stream, so enabling/disabling them (or changing ``curve_shapes``)
    never perturbs the peak/runtime draws — pre-temporal traces are
    bit-identical. ``curve_shapes=("ramp",)`` forces every type onto ramps
    (the temporal benchmarks' worst case for peak-based allocators).

    ``spec`` generates from an explicit :class:`WorkflowSpec` instead of
    the named catalog — the hook :func:`repro.data.ingest.calibrate_generators`
    uses to anchor synthetic sweeps to an ingested real log (``name`` is
    then ignored; every seeded stream keys on ``spec.name``).

    ``arrival_cv`` sets the coefficient of variation of the root
    inter-arrival times via gamma-distributed gaps (mean stays
    ``1 / arrival_rate_per_h``): > 1 is burstier than Poisson, < 1 more
    regular. ``None`` (the default) keeps the EXACT legacy exponential
    draw — ``arrival_cv=1.0`` is the same distribution but a different
    draw path, so pre-existing traces stay bit-identical only with None.
    """
    if spec is None:
        if name is None:
            raise ValueError("need a workflow name or an explicit spec")
        spec = WORKFLOWS[name]
    name = spec.name
    if arrival_cv is not None and arrival_cv <= 0.0:
        raise ValueError(f"arrival_cv must be > 0, got {arrival_cv}")
    names = _type_names(spec)
    if machine_caps_gb:
        machines = tuple(machine_caps_gb)
        machine_cap_gb = max(machine_caps_gb.values())
    dag = WorkflowDAG.chain_of(names)
    stages = dag.stages()
    tasks: list[TaskInstance] = []
    counts: dict[str, int] = {}

    for ti, tname in enumerate(names):
        rng = np.random.default_rng(
            (stable_hash(f"{GENERATOR_VERSION}:{name}:{tname}") + seed)
            % (2 ** 31))
        rel = spec.rel_mix[ti % len(spec.rel_mix)]
        base = rng.uniform(*spec.mem_base_gb)
        in_lo, in_hi = spec.input_gb
        mem = _mem_fn(rel, rng, base, spec.mem_span * base / spec.mem_base_gb[1],
                      in_hi)
        rt_mean = rng.uniform(*spec.runtime_h)
        count = max(3, int(spec.avg_instances * rng.uniform(0.7, 1.3) * scale))
        counts[tname] = count
        machine = machines[ti % len(machines)]
        cap_m = (machine_caps_gb[machine] if machine_caps_gb
                 else machine_cap_gb)

        # input sizes: lognormal clipped into the spec range
        mu = np.log((in_lo + in_hi) / 4.0)
        xs = np.clip(rng.lognormal(mu, 0.8, count), in_lo, in_hi)
        actuals = np.array([
            float(np.clip(mem(x, rng), 0.05, cap_m * 0.9))
            for x in xs
        ])
        # runtime correlates with input size (I/O + compute)
        rts = rt_mean * (0.4 + 0.6 * xs / max(in_hi, 1e-6)) \
            * np.exp(rng.normal(0, 0.2, count))
        preset = _preset_for(float(actuals.max()), spec.preset_factor)

        # memory-over-time curves: separate rng stream (never perturbs the
        # peak/runtime draws above), shape family fixed per task type
        curves: list[tuple[tuple[float, float], ...]] = [()] * count
        if usage_curves:
            crng = np.random.default_rng(
                (stable_hash(f"curves:{GENERATOR_VERSION}:{name}:{tname}")
                 + seed) % (2 ** 31))
            shape = curve_shapes[ti % len(curve_shapes)]
            curves = [_usage_curve(shape, crng, float(actuals[k]))
                      for k in range(count)]

        for k in range(count):
            tasks.append(TaskInstance(
                workflow=name, task_type=tname, machine=machine,
                input_size_gb=float(xs[k]), actual_peak_gb=float(actuals[k]),
                runtime_h=float(rts[k]), user_preset_gb=preset,
                stage=stages[tname], index=k,
                machine_cap_gb=(cap_m if machine_caps_gb else None),
                usage_curve=curves[k]))

    # submission order: by DAG stage, interleaved within a stage
    order_rng = np.random.default_rng(seed + stable_hash(name) % (2 ** 31))
    tasks.sort(key=lambda t: (t.stage, order_rng.random()))

    # instance-level dependency edges + (optional) root arrival process
    edges = dag.instance_edges(counts, seed=seed, fan_in=fan_in)
    arrival_rng = np.random.default_rng(
        (stable_hash(f"arrivals:{name}") + seed) % (2 ** 31))
    clock = 0.0
    final: list[TaskInstance] = []
    for t in tasks:
        deps = edges.get((t.task_type, t.index), ())
        arrival = 0.0
        if arrival_rate_per_h and not deps:
            if arrival_cv is None:
                clock += float(arrival_rng.exponential(
                    1.0 / arrival_rate_per_h))
            else:
                # gamma gaps: mean 1/rate, cv as asked (shape k = 1/cv^2,
                # scale = cv^2/rate) — the burstiness knob calibration fits
                clock += float(arrival_rng.gamma(
                    1.0 / arrival_cv ** 2,
                    arrival_cv ** 2 / arrival_rate_per_h))
            arrival = clock
        final.append(dataclasses.replace(t, deps=deps, arrival_h=arrival))
    return WorkflowTrace(name=name, tasks=final, machine_cap_gb=machine_cap_gb)
