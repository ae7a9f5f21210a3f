"""Self-contained 0-1 constraint-programming solver.

The paper formulates tiling/fusion (§IV-C), scheduling (§IV-B) and memory
allocation (§IV-D) as constraint programs and solves them with an external
CP solver.  No solver ships in this container, so this module implements a
real one: pseudo-boolean linear constraints over 0/1 variables, a linear
(+ pairwise-max) objective, constraint propagation, a caller-supplied warm
start as incumbent, and depth-first branch & bound with activity-based
variable ordering under a wall-clock deadline.

Design notes
------------
* All model variables are booleans.  The paper's integer quantities
  (``MemTh_t``, bank extents) are linearized by the model builders — see
  tiling.py / scheduling.py — so linear pseudo-boolean constraints are
  sufficient and keep propagation cheap.
* The scheduling objective Eq. (8) contains ``max(l_DM(t), l_C(t))``
  per tick; :class:`MaxTerm` supports exactly that shape.  Its lower bound
  under a partial assignment is ``max_k(lb(expr_k))`` which keeps B&B
  bounds admissible.
* ``solve`` always returns the best incumbent found; ``optimal`` is True
  only when the search space was exhausted within the deadline.

Engines
-------
:func:`solve` is the incremental engine: per-variable constraint watch
lists keep a cached slack per constraint that is updated on
assignment/backtrack (no per-node full rescan), the objective lower bound
— including every :class:`MaxTerm` — is maintained incrementally so bound
checks are O(1), conflicts bump VSIDS-style variable activities (with
decay) that steer the branching order across geometric restarts, and the
incumbent drives objective-bound tightening (variables whose flip would
exceed the remaining gap are fixed).  :func:`solve_reference` preserves
the original full-rescan engine for regression tests and as the "seed
compiler" baseline in ``benchmarks/compile_bench.py``.  Both engines
explore admissible bounds only, so they agree on the optimum whenever
they prove optimality.

:func:`solve_many` solves a batch of *independent* models — the paper's
partitioned sub-problems (Table II) — concurrently on a process pool
(the solver is pure Python, so threads would serialize on the GIL),
falling back to in-process serial solving when the platform cannot fork.

Copy of the JAX package's ``core/cpsolver.py`` (pure Python; the port imports
nothing of that package and keeps its own copy).  The tests hold
it equal to the original.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Terms = Sequence[Tuple[int, int]]  # (var_id, coef)


@dataclass
class MaxTerm:
    """Objective contribution ``max_k(const_k + sum coef*var)``."""

    exprs: List[Tuple[int, Terms]]  # (const, terms)

    def value(self, vals: Sequence[int]) -> int:
        return max(c + sum(co * vals[v] for v, co in t)
                   for c, t in self.exprs)

    def lower_bound(self, vals: Sequence[int], assigned: Sequence[bool]
                    ) -> int:
        lb = None
        for c, t in self.exprs:
            e = c
            for v, co in t:
                if assigned[v]:
                    e += co * vals[v]
                elif co < 0:
                    e += co
            lb = e if lb is None else max(lb, e)
        return lb or 0


@dataclass
class _Constraint:
    vars: List[int]
    coefs: List[int]
    rhs: int               # sum coefs*x <= rhs
    name: str = ""


@dataclass
class Solution:
    values: Dict[int, int]
    objective: float
    optimal: bool
    feasible: bool
    nodes: int
    wall_s: float

    def __getitem__(self, var: int) -> int:
        return self.values[var]


class CPModel:
    def __init__(self, name: str = "model"):
        self.name = name
        self.n_vars = 0
        self.var_names: List[str] = []
        self.cons: List[_Constraint] = []
        self.obj_terms: List[Tuple[int, int]] = []
        self.obj_const: int = 0
        self.max_terms: List[MaxTerm] = []
        self.fixed: Dict[int, int] = {}

    # ---- variables ----
    def bool(self, name: str = "") -> int:
        vid = self.n_vars
        self.n_vars += 1
        self.var_names.append(name or f"x{vid}")
        return vid

    def fix(self, var: int, val: int) -> None:
        self.fixed[var] = int(val)

    def fix_many(self, assignments: Dict[int, int]) -> None:
        """Bulk fixed assignment — how precondition/boundary state
        enters a model cheaply (e.g. the windowed fusion CPs' carry
        state): fixed vars are assigned and propagated once at the root
        and excluded from branching entirely."""
        for v, val in assignments.items():
            self.fixed[v] = int(val)

    # ---- constraints (normalized to <=) ----
    def add(self, terms: Terms, sense: str, rhs: int, name: str = "") -> None:
        terms = [(v, c) for v, c in terms if c != 0]
        if sense == "<=":
            self.cons.append(_Constraint([v for v, _ in terms],
                                         [c for _, c in terms], rhs, name))
        elif sense == ">=":
            self.cons.append(_Constraint([v for v, _ in terms],
                                         [-c for _, c in terms], -rhs, name))
        elif sense == "==":
            self.add(terms, "<=", rhs, name)
            self.add(terms, ">=", rhs, name)
        else:
            raise ValueError(sense)

    def add_implies(self, a: int, b: int, name: str = "") -> None:
        """a -> b   ==   a - b <= 0."""
        self.add([(a, 1), (b, -1)], "<=", 0, name)

    def add_at_most_one(self, vars_: Iterable[int], name: str = "") -> None:
        self.add([(v, 1) for v in vars_], "<=", 1, name)

    def add_exactly_one(self, vars_: Iterable[int], name: str = "") -> None:
        self.add([(v, 1) for v in vars_], "==", 1, name)

    # ---- objective ----
    def minimize(self, terms: Terms = (), const: int = 0,
                 max_terms: Sequence[MaxTerm] = ()) -> None:
        self.obj_terms = list(terms)
        self.obj_const = const
        self.max_terms = list(max_terms)

    def objective_value(self, vals: Sequence[int]) -> int:
        o = self.obj_const + sum(c * vals[v] for v, c in self.obj_terms)
        for mt in self.max_terms:
            o += mt.value(vals)
        return o

    def check(self, vals: Sequence[int]) -> List[str]:
        """Return names of violated constraints (empty == feasible)."""
        bad = []
        for con in self.cons:
            s = sum(c * vals[v] for v, c in zip(con.vars, con.coefs))
            if s > con.rhs:
                bad.append(con.name or "<unnamed>")
        for v, val in self.fixed.items():
            if vals[v] != val:
                bad.append(f"fixed:{self.var_names[v]}")
        return bad


# --------------------------------------------------------------------------
# Incremental solver
# --------------------------------------------------------------------------

_ACT_DECAY = 1.0 / 0.95
_ACT_RESCALE = 1e100
_TIME_CHECK_MASK = 63          # poll the clock every 64 expansions

#: default incumbent-stall cutoff (search nodes) used by the compiler's
#: windowed/partitioned CPs — the single source for the option defaults
#: in pipeline.CompilerOptions, scheduling.SchedOptions and plan_tiling.
DEFAULT_STALL_NODES = 16_000


def solve(model: CPModel, time_limit_s: float = 10.0,
          warm_start: Optional[Dict[int, int]] = None,
          stall_limit_s: Optional[float] = None,
          stall_limit_nodes: Optional[int] = None) -> Solution:
    """Branch & bound with incremental propagation.

    ``stall_limit_s`` / ``stall_limit_nodes``, when set, stop the search
    early once no better incumbent has been found for that long (wall
    seconds / search nodes) — the windowed scheduling CPs converge almost
    immediately from their warm starts and then spend the rest of the
    deadline proving optimality, which the anytime caller does not need.
    The node-based cutoff is deterministic: the same model explores the
    same tree regardless of machine load.  ``optimal`` is only True on
    full exhaustion.
    """
    t0 = time.monotonic()
    deadline = t0 + time_limit_s
    n = model.n_vars
    cons = model.cons
    n_cons = len(cons)

    cvars: List[List[Tuple[int, int]]] = [
        list(zip(c.vars, c.coefs)) for c in cons]
    occ: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for ci, pairs in enumerate(cvars):
        for v, co in pairs:
            occ[v].append((ci, co))

    obj_coef = [0] * n
    for v, c in model.obj_terms:
        obj_coef[v] += c

    # ---- incumbent from warm start ----
    best_vals: Optional[List[int]] = None
    best_obj = float("inf")
    if warm_start is not None:
        ws = [0] * n
        for v, val in warm_start.items():
            ws[v] = int(val)
        for v, val in model.fixed.items():
            ws[v] = val
        if not model.check(ws):
            best_vals = ws
            best_obj = model.objective_value(ws)

    # ---- incremental search state ----
    vals = [0] * n
    assigned = [False] * n
    # slack[ci] = rhs - (sum of min contribution of every var in ci);
    # assignments only ever *decrease* slack, backtracking restores it.
    slack = [c.rhs - sum(min(0, co) for co in c.coefs) for c in cons]

    # linear objective lower bound, maintained incrementally
    lin_lb = model.obj_const + sum(min(0, c) for c in obj_coef)

    # MaxTerm lower bounds, memoized per expression and maintained
    # incrementally: expr_lb[m][e] is exact for the current partial
    # assignment, mt_lb[m] = max_e expr_lb[m][e], total_mt = sum_m mt_lb.
    mts = model.max_terms
    expr_lb: List[List[int]] = []
    mt_lb: List[int] = []
    v2mt: Dict[int, List[Tuple[int, int, int]]] = {}
    for m, mt in enumerate(mts):
        lbs = []
        for e, (c, terms) in enumerate(mt.exprs):
            lbs.append(c + sum(min(0, co) for _, co in terms))
            for v, co in terms:
                if co:
                    v2mt.setdefault(v, []).append((m, e, co))
        expr_lb.append(lbs)
        mt_lb.append(max(lbs) if lbs else 0)
    total_mt = sum(mt_lb)

    trail: List[Tuple[int, List[Tuple[int, int]], int,
                      List[Tuple[int, int, int, int]]]] = []
    queue: List[int] = []
    queued = bytearray(n_cons)
    activity = [0.0] * n
    act_inc = 1.0
    conflict_ci = -1
    nodes = 0

    def assign(v: int, val: int) -> bool:
        """Assign and incrementally update slacks + objective bound.
        Returns False on constraint conflict."""
        nonlocal lin_lb, total_mt, conflict_ci
        vals[v] = val
        assigned[v] = True
        schanges: List[Tuple[int, int]] = []
        ok = True
        for ci, co in occ[v]:
            d = co * val - (co if co < 0 else 0)   # slack decrease, >= 0
            if d:
                s = slack[ci] - d
                slack[ci] = s
                schanges.append((ci, d))
                if s < 0:
                    ok = False
                    conflict_ci = ci
                elif not queued[ci]:
                    queued[ci] = 1
                    queue.append(ci)
        oc = obj_coef[v]
        dlin = oc * val - (oc if oc < 0 else 0)
        lin_lb += dlin
        mtch: List[Tuple[int, int, int, int]] = []
        for m, e, co in v2mt.get(v, ()):
            d = co * val - (co if co < 0 else 0)
            if d:
                old = mt_lb[m]
                lbs = expr_lb[m]
                lbs[e] += d
                if lbs[e] > old:
                    mt_lb[m] = lbs[e]
                    total_mt += lbs[e] - old
                mtch.append((m, e, d, old))
        trail.append((v, schanges, dlin, mtch))
        return ok

    def rewind(mark: int) -> None:
        nonlocal lin_lb, total_mt
        while len(trail) > mark:
            v, schanges, dlin, mtch = trail.pop()
            assigned[v] = False
            vals[v] = 0
            for ci, d in schanges:
                slack[ci] += d
            lin_lb -= dlin
            for m, e, d, old in reversed(mtch):
                expr_lb[m][e] -= d
                total_mt += old - mt_lb[m]
                mt_lb[m] = old

    def reset_queue() -> None:
        for ci in queue:
            queued[ci] = 0
        queue.clear()

    def run_queue() -> bool:
        """Drain the propagation queue, unit-forcing implied vars.  Only
        constraints whose slack shrank since last visit are re-examined."""
        while queue:
            ci = queue.pop()
            queued[ci] = 0
            s = slack[ci]
            if s < 0:
                return False
            for v, co in cvars[ci]:
                if assigned[v]:
                    continue
                if co > s:
                    if not assign(v, 0):
                        return False
                elif -co > s:
                    if not assign(v, 1):
                        return False
        return True

    # objective vars by |coef| (descending) for incumbent-driven
    # bound tightening
    obj_order_vars = sorted((v for v in range(n) if obj_coef[v]),
                            key=lambda v: -abs(obj_coef[v]))

    def node_fixpoint() -> bool:
        """Propagate + bound-check + tighten to fixpoint.  False means
        the node is pruned (conflict or objective bound)."""
        while True:
            if not run_queue():
                return False
            lb = lin_lb + total_mt
            if lb >= best_obj:
                return False
            gap = best_obj - lb
            forced = False
            for v in obj_order_vars:
                oc = obj_coef[v]
                if (oc if oc > 0 else -oc) < gap:
                    break
                if assigned[v]:
                    continue
                # flipping v to its expensive side alone would close the
                # remaining gap -> force the cheap side
                if not assign(v, 0 if oc > 0 else 1):
                    return False
                forced = True
            if not forced:
                return True

    def bump_conflict() -> None:
        nonlocal act_inc, activity
        if conflict_ci >= 0:
            for v, _ in cvars[conflict_ci]:
                activity[v] += act_inc
            act_inc *= _ACT_DECAY
            if act_inc > _ACT_RESCALE:
                activity = [a / _ACT_RESCALE for a in activity]
                act_inc = 1.0

    # branching order: activity (after restarts), then objective-
    # coefficient magnitude, then index.  Fixed vars (preconditions /
    # boundary state, see CPModel.fix_many) are assigned at the root and
    # never branched on.
    free = [v for v in range(n) if v not in model.fixed] \
        if model.fixed else list(range(n))
    order = sorted(free, key=lambda v: (-abs(obj_coef[v]), v))
    n_order = len(order)

    # ---- root: fixed vars + initial propagation over ALL constraints
    # (a constraint can be violated or unit-forcing before any
    # assignment, e.g. 3x <= -1 or 3x <= 2)
    root_ok = True
    for v, val in model.fixed.items():
        if assigned[v]:
            if vals[v] != val:
                root_ok = False
                break
            continue
        if not assign(v, val):
            root_ok = False
            break
    if root_ok:
        for ci in range(n_cons):
            if not queued[ci]:
                queued[ci] = 1
                queue.append(ci)
        root_ok = run_queue()     # plain propagation: root must not be
    reset_queue()                 # pruned by a warm-start bound

    optimal = False
    if root_ok:
        root_mark = len(trail)
        # iterative DFS (the fusion CPs reach thousands of variables —
        # deeper than Python's recursion limit)
        stack: List[List] = []      # [var, values-to-try, trail-mark, pos]
        cur_pos = 0
        conflicts = 0
        restart_at = 2048
        last_improve = t0
        improve_node = 0
        stalled = timed_out = False
        descend = True
        while True:
            if descend:
                i = cur_pos
                while i < n_order and assigned[order[i]]:
                    i += 1
                if i >= n_order:
                    obj = lin_lb + total_mt   # exact at full assignment
                    if obj < best_obj:
                        best_obj = obj
                        best_vals = list(vals)
                        last_improve = time.monotonic()
                        improve_node = nodes
                    descend = False
                    continue
                v = order[i]
                first = 0 if obj_coef[v] >= 0 else 1
                stack.append([v, [first, 1 - first], len(trail), i])
                descend = False
                continue
            if not stack:
                optimal = not (stalled or timed_out)
                break
            frame = stack[-1]
            if not frame[1]:
                rewind(frame[2])
                stack.pop()
                continue
            val = frame[1].pop(0)
            rewind(frame[2])
            reset_queue()
            nodes += 1
            if stall_limit_nodes is not None \
                    and nodes - improve_node > stall_limit_nodes:
                stalled = True
            if nodes & _TIME_CHECK_MASK == 0:
                now = time.monotonic()
                if now > deadline:
                    timed_out = True
                elif stall_limit_s is not None \
                        and now - last_improve > stall_limit_s:
                    stalled = True
            if stalled or timed_out:
                rewind(0)
                break
            ok = assign(frame[0], val)
            if ok:
                ok = node_fixpoint()
            if ok:
                cur_pos = frame[3] + 1
                descend = True
            else:
                conflicts += 1
                bump_conflict()
                if conflicts >= restart_at and stack:
                    # geometric restart with activity-reordered branching
                    restart_at *= 2
                    rewind(root_mark)
                    reset_queue()
                    stack.clear()
                    order = sorted(
                        free,
                        key=lambda v: (-activity[v], -abs(obj_coef[v]), v))
                    cur_pos = 0
                    descend = True

    wall = time.monotonic() - t0
    if best_vals is None:
        return Solution({}, float("inf"), optimal, False, nodes, wall)
    return Solution({v: best_vals[v] for v in range(n)},
                    float(best_obj), optimal, True, nodes, wall)


# --------------------------------------------------------------------------
# Reference (seed) solver — full constraint rescan per node.  Kept as the
# regression oracle and as the baseline engine timed by compile_bench.
# --------------------------------------------------------------------------


class _SearchState:
    __slots__ = ("vals", "assigned", "minsum", "trail")

    def __init__(self, n_vars: int, cons: List[_Constraint]):
        self.vals = [0] * n_vars
        self.assigned = [False] * n_vars
        # minsum[c] = sum of min contribution of every var in constraint c
        self.minsum = [sum(min(0, co) for co in c.coefs) for c in cons]
        self.trail: List[Tuple[int, List[Tuple[int, int]]]] = []


def solve_reference(model: CPModel, time_limit_s: float = 10.0,
                    warm_start: Optional[Dict[int, int]] = None,
                    stall_limit_s: Optional[float] = None,
                    stall_limit_nodes: Optional[int] = None) -> Solution:
    # stall limits are accepted (engine-interchangeable signature) but
    # ignored: the seed engine always runs to deadline or exhaustion
    t0 = time.monotonic()
    deadline = t0 + time_limit_s
    n = model.n_vars
    cons = model.cons

    # occurrence lists: var -> [(constraint index, coef)]
    occ: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for ci, c in enumerate(cons):
        for v, co in zip(c.vars, c.coefs):
            occ[v].append((ci, co))

    obj_coef = [0] * n
    for v, c in model.obj_terms:
        obj_coef[v] += c

    # ---- incumbent from warm start ----
    best_vals: Optional[List[int]] = None
    best_obj = float("inf")
    if warm_start is not None:
        ws = [0] * n
        for v, val in warm_start.items():
            ws[v] = int(val)
        for v, val in model.fixed.items():
            ws[v] = val
        if not model.check(ws):
            best_vals = ws
            best_obj = model.objective_value(ws)

    st = _SearchState(n, cons)
    nodes = 0

    def assign(v: int, val: int) -> bool:
        """Assign and update minsums.  Returns False on conflict."""
        changed: List[Tuple[int, int]] = []
        st.vals[v] = val
        st.assigned[v] = True
        ok = True
        for ci, co in occ[v]:
            old_min = min(0, co)
            new_min = co * val
            if new_min != old_min:
                st.minsum[ci] += new_min - old_min
                changed.append((ci, new_min - old_min))
            if st.minsum[ci] > cons[ci].rhs:
                ok = False
        st.trail.append((v, changed))
        return ok

    def undo() -> None:
        v, changed = st.trail.pop()
        st.assigned[v] = False
        st.vals[v] = 0
        for ci, delta in changed:
            st.minsum[ci] -= delta

    def propagate(level_mark: int) -> bool:
        """Unit-force vars whose assignment is implied.  Appends to trail;
        caller rewinds to level_mark on failure."""
        moved = True
        while moved:
            moved = False
            for ci, c in enumerate(cons):
                slack = c.rhs - st.minsum[ci]
                if slack < 0:
                    return False
                for v, co in zip(c.vars, c.coefs):
                    if st.assigned[v]:
                        continue
                    if co > 0 and co > slack:
                        if not assign(v, 0):
                            return False
                        moved = True
                    elif co < 0 and -co > slack:
                        if not assign(v, 1):
                            return False
                        moved = True
        return True

    def obj_lb() -> float:
        lb = model.obj_const
        for v in range(n):
            if st.assigned[v]:
                lb += obj_coef[v] * st.vals[v]
            elif obj_coef[v] < 0:
                lb += obj_coef[v]
        for mt in model.max_terms:
            lb += mt.lower_bound(st.vals, st.assigned)
        return lb

    # static branching order: objective-coefficient magnitude, then index
    order = sorted(range(n), key=lambda v: (-abs(obj_coef[v]), v))

    # apply fixed vars up front
    root_ok = True
    for v, val in model.fixed.items():
        if not assign(v, val):
            root_ok = False
    if root_ok:
        root_ok = propagate(0)

    def dfs(depth: int) -> None:
        nonlocal nodes, best_vals, best_obj
        if time.monotonic() > deadline:
            raise TimeoutError
        nodes += 1
        if obj_lb() >= best_obj:
            return
        # pick next unassigned var
        v = next((u for u in order if not st.assigned[u]), None)
        if v is None:
            obj = model.objective_value(st.vals)
            if obj < best_obj:
                best_obj = obj
                best_vals = list(st.vals)
            return
        # value order: cheaper objective contribution first
        first = 0 if obj_coef[v] >= 0 else 1
        for val in (first, 1 - first):
            mark = len(st.trail)
            ok = assign(v, val)
            if ok:
                ok = propagate(mark)
            if ok:
                dfs(depth + 1)
            while len(st.trail) > mark:
                undo()

    optimal = False
    if root_ok:
        try:
            dfs(0)
            optimal = True
        except (TimeoutError, RecursionError):
            optimal = False

    wall = time.monotonic() - t0
    if best_vals is None:
        return Solution({}, float("inf"), optimal, False, nodes, wall)
    return Solution({v: best_vals[v] for v in range(n)},
                    float(best_obj), optimal, True, nodes, wall)


ENGINES = {"incremental": solve, "reference": solve_reference}


# --------------------------------------------------------------------------
# Batch solving of independent sub-problems (Table II partitioning)
# --------------------------------------------------------------------------


@dataclass
class SolveTask:
    model: CPModel
    time_limit_s: float = 10.0
    warm_start: Optional[Dict[int, int]] = None
    stall_limit_s: Optional[float] = None
    stall_limit_nodes: Optional[int] = None
    engine: str = "incremental"


def _run_task(task: SolveTask) -> Solution:
    fn = ENGINES[task.engine]
    return fn(task.model, time_limit_s=task.time_limit_s,
              warm_start=task.warm_start,
              stall_limit_s=task.stall_limit_s,
              stall_limit_nodes=task.stall_limit_nodes)


def solve_many(tasks: Sequence[SolveTask], parallel: bool = True,
               max_workers: Optional[int] = None) -> List[Solution]:
    """Solve independent CP models, concurrently when possible.

    The partitioned scheduling/tiling sub-problems share no variables, so
    they can be dispatched to worker processes (fork start method: the
    models are inherited or pickled as plain data).  Any pool failure —
    no fork support, sandboxed semaphores, worker crash, a hung child —
    falls back to solving everything serially in-process, so callers
    never see an exception from the parallelism itself.

    Forking a multi-threaded process can deadlock the child (e.g. after
    CUDA or a library spins up its threads), and a deadlock is a hang, not an
    exception — so the pool is only used from single-threaded processes
    and every wait carries a deadline.
    """
    import threading

    tasks = list(tasks)
    if len(tasks) <= 1 or not parallel or threading.active_count() > 1:
        return [_run_task(t) for t in tasks]
    ex = None
    try:
        import concurrent.futures as cf
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        workers = max_workers or min(len(tasks), os.cpu_count() or 1)
        ex = cf.ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
        futs = [ex.submit(_run_task, t) for t in tasks]
        deadline = time.monotonic() + \
            sum(t.time_limit_s for t in tasks) + 60.0
        out = [f.result(timeout=max(1.0, deadline - time.monotonic()))
               for f in futs]
        ex.shutdown()
        return out
    except Exception:
        if ex is not None:          # don't join a possibly-hung worker
            ex.shutdown(wait=False, cancel_futures=True)
        return [_run_task(t) for t in tasks]


def brute_force(model: CPModel) -> Solution:
    """Exhaustive reference solver for tests (<= ~20 vars)."""
    n = model.n_vars
    assert n <= 22, "brute_force is for tiny models"
    best = None
    best_obj = float("inf")
    for mask in range(1 << n):
        vals = [(mask >> i) & 1 for i in range(n)]
        if any(vals[v] != val for v, val in model.fixed.items()):
            continue
        if model.check(vals):
            continue
        o = model.objective_value(vals)
        if o < best_obj:
            best_obj = o
            best = vals
    if best is None:
        return Solution({}, float("inf"), True, False, 1 << n, 0.0)
    return Solution({v: best[v] for v in range(n)}, float(best_obj),
                    True, True, 1 << n, 0.0)
