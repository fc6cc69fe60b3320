"""Bayes tree — variable elimination, clique tree, and tree-scheduled solves.

Reference contract (SURVEY.md §3.2): IIF builds a Bayes tree from a variable
elimination ordering (getEliminationOrder -> buildTreeFromOrdering!,
exercised at test/testDeadReckoningTether.jl:56-60), then runs clique-wise
upsolve/downsolve belief propagation, recycling unchanged cliques on
re-solve (solveTree!(fg, tree); calcCliquesRecycled counters at
examples/ManhattanDatasetIncremental.jl:112-115).

Design stance (SURVEY.md §7 hard parts): the tree is host-side
scheduling metadata; the per-clique work (approxConv messages, Gibbs belief
products) stays as the engine's batched device kernels. Cliques on the same
tree level are independent and dispatch together.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from rome_tpu.graph.graph import FactorGraph


# ----------------------- elimination ordering -------------------------------

def get_elimination_order(fg: FactorGraph, constraints=(), maxincidence: Optional[int] = None):
    """Approximate-minimum-degree elimination order over solvable variables.

    ``constraints`` lists variables forced to the END of the order (eliminated
    last -> near the root), mirroring IIF's constraint kwarg. ``maxincidence``
    guards against hub variables exploding fill-in (SolverParams.maxincidence,
    MITDatasetBatch.jl:42)."""
    maxincidence = maxincidence or fg.params.maxincidence
    # adjacency between variables through shared factors
    adj: dict[str, set] = {}
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        vs = [v for v in f.variables if fg.variables[v].solvable > 0]
        for v in vs:
            adj.setdefault(v, set()).update(u for u in vs if u != v)
    for v in fg._var_order:
        if fg.variables[v].solvable > 0:
            adj.setdefault(v, set())

    # hub guard: a variable with more connections than maxincidence signals a
    # malformed graph (SolverParams.maxincidence semantics)
    for v, n in adj.items():
        if len(n) > maxincidence:
            raise RuntimeError(
                f"variable {v} exceeds maxincidence={maxincidence} "
                f"({len(n)} neighbors)"
            )

    last = [v for v in constraints if v in adj]
    order = []
    work = {v: set(n) for v, n in adj.items() if v not in last}
    while work:
        # min-degree choice, insertion order as tiebreak
        v = min(work, key=lambda u: (len(work[u]), fg._var_order.index(u)))
        order.append(v)
        nbrs = work.pop(v)
        # connect the eliminated variable's neighbors (fill-in)
        for a in nbrs:
            if a in work:
                work[a].discard(v)
                work[a].update(b for b in nbrs if b != a and b in work)
    order.extend(last)
    return order


# ----------------------------- tree types -----------------------------------

@dataclass
class Clique:
    index: int
    frontals: list
    separator: list
    factors: list = field(default_factory=list)
    parent: Optional[int] = None
    children: list = field(default_factory=list)
    # content signature for recycling decisions
    signature: tuple = ()

    @property
    def variables(self):
        return list(self.frontals) + list(self.separator)

    def __repr__(self):
        return f"Clique({','.join(self.frontals)} | {','.join(self.separator)})"


@dataclass
class BayesTree:
    cliques: list                      # list[Clique], root is index 0
    order: list                        # elimination order used
    levels: list = field(default_factory=list)  # list[list[int]] root-first
    build_time: float = 0.0
    num_recycled: int = 0
    dirty: set = field(default_factory=set)  # clique indices re-solved

    @property
    def num_cliques(self):
        return len(self.cliques)

    def clique_of(self, var: str) -> Optional[Clique]:
        for c in self.cliques:
            if var in c.frontals:
                return c
        return None


def calc_cliques_recycled(tree: BayesTree):
    """calcCliquesRecycled analogue: (total, reused)."""
    return tree.num_cliques, tree.num_recycled


# --------------------------- tree construction ------------------------------

def build_tree_from_ordering(
    fg: FactorGraph, order=None, old_tree: Optional[BayesTree] = None
) -> BayesTree:
    """Symbolic elimination -> Bayes tree (buildTreeFromOrdering! analogue).

    Standard construction: eliminating v creates a conditional
    p(v | S_v) with S_v = v's remaining neighbors after fill-in; v joins its
    parent clique when S_v matches the parent's frontal+separator scope,
    otherwise starts a new clique with separator S_v."""
    import time as _time

    t0 = _time.time()
    order = order or get_elimination_order(fg)
    pos = {v: i for i, v in enumerate(order)}

    # rebuild adjacency with fill-in to get each variable's separator
    adj: dict[str, set] = {v: set() for v in order}
    fct_of_var: dict[str, list] = {v: [] for v in order}
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        vs = [v for v in f.variables if v in pos]
        for v in vs:
            adj[v].update(u for u in vs if u != v)
            fct_of_var[v].append(flabel)

    seps: dict[str, list] = {}
    work = {v: set(n) for v, n in adj.items()}
    for v in order:
        nbrs = {u for u in work[v] if pos[u] > pos[v]}
        seps[v] = sorted(nbrs, key=lambda u: pos[u])
        for a in nbrs:
            work[a].update(b for b in nbrs if b != a)
            work[a].discard(v)

    # group conditionals into cliques (maximal-clique supernodes)
    cliques: list[Clique] = []
    clique_of: dict[str, int] = {}
    for v in reversed(order):  # root side first
        S = seps[v]
        if not S:
            c = Clique(index=len(cliques), frontals=[v], separator=[])
            cliques.append(c)
            clique_of[v] = c.index
            continue
        # parent candidate: clique of the first (earliest-eliminated-after-v)
        # separator variable
        first = min(S, key=lambda u: pos[u])
        pidx = clique_of[first]
        parent = cliques[pidx]
        if set(S) == set(parent.frontals) | set(parent.separator) or (
            set(S) <= set(parent.frontals) | set(parent.separator)
            and len(parent.frontals) + len(S) <= len(parent.variables)
            and set(S) >= set(parent.separator)
        ):
            # absorb: v becomes a frontal of the parent clique
            parent.frontals.append(v)
            clique_of[v] = pidx
        else:
            c = Clique(
                index=len(cliques), frontals=[v], separator=list(S), parent=pidx
            )
            cliques.append(c)
            parent.children.append(c.index)
            clique_of[v] = c.index

    # assign factors to the clique where their LAST-eliminated variable lives
    for flabel in fg._fct_order:
        f = fg.factors[flabel]
        if f.solvable <= 0:
            continue
        vs = [v for v in f.variables if v in pos]
        if not vs:
            continue
        lead = min(vs, key=lambda u: pos[u])
        cliques[clique_of[lead]].factors.append(flabel)

    # signatures for recycling
    for c in cliques:
        c.signature = (
            tuple(sorted(c.frontals)),
            tuple(sorted(c.separator)),
            tuple(sorted(c.factors)),
        )

    # levels (root-first BFS over all roots)
    levels: list[list[int]] = []
    frontier = [c.index for c in cliques if c.parent is None]
    seen = set()
    while frontier:
        levels.append(frontier)
        seen.update(frontier)
        frontier = [
            k for i in frontier for k in cliques[i].children if k not in seen
        ]

    tree = BayesTree(
        cliques=cliques, order=order, levels=levels,
        build_time=_time.time() - t0,
    )
    if old_tree is not None:
        old_sigs = {c.signature for c in old_tree.cliques}
        tree.num_recycled = sum(1 for c in cliques if c.signature in old_sigs)
    return tree


# ------------------------------ tree solve ----------------------------------

def _dirty_cliques(tree: BayesTree, old_tree: Optional[BayesTree]):
    """Cliques that must be re-solved: any clique whose signature is not in
    the old tree, plus all its ancestors (upsolve messages flow rootward).
    Signature-matched cliques off the dirty path are RECYCLED — skipped
    entirely, beliefs bit-identical (solveTree!(fg, tree) semantics,
    testBeehiveGrow.jl:20-28)."""
    if old_tree is None:
        tree.num_recycled = 0
        return {c.index for c in tree.cliques}
    old_sigs = {c.signature for c in old_tree.cliques}
    dirty: set = set()
    for c in tree.cliques:
        if c.signature not in old_sigs:
            i = c.index
            while i is not None and i not in dirty:
                dirty.add(i)
                i = tree.cliques[i].parent
    tree.num_recycled = tree.num_cliques - len(dirty)
    return dirty


def solve_tree(
    fg: FactorGraph,
    old_tree: Optional[BayesTree] = None,
    solve_key: str = "default",
    N: Optional[int] = None,
    key=None,
    init: bool = True,
    downsolve: Optional[bool] = None,
    engine: str = "batched",
) -> BayesTree:
    """solveTree!(fg[, oldtree]) analogue: build (recycling against the old
    tree), then clique-scheduled nonparametric belief propagation —
    upsolve leaves->root, then downsolve root->leaves (SolverParams.downsolve)
    — and surface means as point estimates.

    engine="batched": every tree level dispatches as ONE pair of compiled
    calls (all messages of the level's cliques batched; products vmapped
    over the level's frontal variables), with upsolve messages restricted to
    each clique's subtree-assigned factors. Recycled cliques are skipped —
    their beliefs pass through bit-identical.
    engine="loop": per-variable host loop (reference-shaped cross-check).
    """
    from rome_tpu.solvers.multimodal.kde import manifold_mean
    from rome_tpu.solvers.multimodal.solve import init_all_beliefs, predict_belief

    N = N or fg.params.N
    key = key if key is not None else jax.random.PRNGKey(1331)
    downsolve = fg.params.downsolve if downsolve is None else downsolve
    tree = build_tree_from_ordering(fg, old_tree=old_tree)
    dirty = _dirty_cliques(tree, old_tree)
    tree.dirty = dirty
    if fg.params.showtree:
        print(format_tree(tree))
    if fg.params.drawtree:
        import os

        os.makedirs(fg.params.logpath, exist_ok=True)
        with open(os.path.join(fg.params.logpath, "bt.txt"), "w") as fh:
            fh.write(format_tree(tree))

    if init:
        init_all_beliefs(fg, solve_key, N=N, key=jax.random.fold_in(key, 0))

    if engine == "batched":
        _solve_tree_batched(
            fg, tree, dirty, solve_key, N, key, downsolve,
            restrict_subtree=fg.params.useMsgLikelihoods,
        )
        if fg.params.dbg:
            import json
            import os

            os.makedirs(fg.params.logpath, exist_ok=True)
            with open(
                os.path.join(fg.params.logpath, "solve_dbg.json"), "w"
            ) as fh:
                json.dump(
                    {
                        "num_cliques": tree.num_cliques,
                        "num_recycled": tree.num_recycled,
                        "dirty": sorted(dirty),
                        "levels": [list(l) for l in tree.levels],
                        "build_time": tree.build_time,
                    },
                    fh,
                )
        return tree

    def update_clique(cidx: int, kk):
        c = tree.cliques[cidx]
        for j, v in enumerate(c.frontals):
            rec = fg.variables[v]
            if rec.solvable <= 0 or rec.marginalized:
                continue
            pts = predict_belief(
                fg, v, solve_key=solve_key, key=jax.random.fold_in(kk, j), N=N
            )
            if pts is not None:
                rec.beliefs[solve_key] = pts

    # upsolve: deepest level first
    for li, level in enumerate(reversed(tree.levels)):
        for cidx in level:  # same-level cliques are independent
            if cidx not in dirty:
                continue
            update_clique(cidx, jax.random.fold_in(key, 10000 + li * 100 + cidx))
    # downsolve: root outward (downsolve/limitfixeddown semantics)
    if downsolve:
        for li, level in enumerate(tree.levels):
            for cidx in level:
                if cidx not in dirty:
                    continue
                update_clique(cidx, jax.random.fold_in(key, 50000 + li * 100 + cidx))

    for label, rec in fg.variables.items():
        if solve_key in rec.beliefs:
            if fg.variables[label].solvable <= 0 or rec.marginalized:
                continue
            mu = manifold_mean(rec.manifold, rec.beliefs[solve_key])
            rec.points[solve_key] = np.asarray(mu, dtype=np.float64)
            rec.initialized[solve_key] = True
    return tree


def format_tree(tree: BayesTree) -> str:
    """ASCII rendering of the Bayes tree (drawTree/showTree analogue,
    MITDatasetBatch.jl:46-50)."""
    lines = [
        f"BayesTree: {tree.num_cliques} cliques, "
        f"{len(tree.levels)} levels, {tree.num_recycled} recycled"
    ]

    def walk(ci, depth):
        c = tree.cliques[ci]
        mark = "*" if ci in tree.dirty else " "
        lines.append(
            "  " * depth
            + f"{mark}[{ci}] {','.join(c.frontals)} | {','.join(c.separator)}"
            + (f"  ({len(c.factors)} fct)" if c.factors else "")
        )
        for ch in c.children:
            walk(ch, depth + 1)

    for c in tree.cliques:
        if c.parent is None:
            walk(c.index, 1)
    return "\n".join(lines)


drawTree = format_tree


def _solve_tree_batched(
    fg, tree, dirty, solve_key, N, key, downsolve, restrict_subtree=True
):
    """Level-batched tree schedule over the compiled sweep kernels."""
    from rome_tpu.solvers.multimodal.batched import BatchedNonparametricSolver
    from rome_tpu.solvers.multimodal.kde import manifold_mean

    solver = BatchedNonparametricSolver(fg, solve_key, N=N)
    ga, bp = solver.ga, solver.bp
    beliefs = solver.gather_beliefs()

    # clique bookkeeping: factor -> clique, subtree factor sets
    clique_of_fct = {}
    for c in tree.cliques:
        for fl in c.factors:
            clique_of_fct[fl] = c.index
    subtree_facts: dict[int, set] = {}

    def facts_of_subtree(ci):
        if ci in subtree_facts:
            return subtree_facts[ci]
        c = tree.cliques[ci]
        s = set(c.factors)
        for ch in c.children:
            s |= facts_of_subtree(ch)
        subtree_facts[ci] = s
        return s

    var_slot = {
        lbl: (t, s)
        for t in ga.type_names
        for s, lbl in enumerate(ga.var_labels[t])
    }
    touched = {t: np.zeros(ga.counts[t]) for t in ga.type_names}

    def level_masks(cliques_sel, restrict_subtree):
        var_masks = {t: np.zeros(ga.counts[t]) for t in ga.type_names}
        msg_masks = (
            {t: np.zeros((ga.counts[t], bp.kmax[t])) for t in ga.type_names}
            if restrict_subtree
            else {t: np.ones((ga.counts[t], bp.kmax[t])) for t in ga.type_names}
        )
        for ci in cliques_sel:
            c = tree.cliques[ci]
            allowed = facts_of_subtree(ci) if restrict_subtree else None
            for v in c.frontals:
                if v not in var_slot:
                    continue
                rec = fg.variables[v]
                if rec.solvable <= 0 or rec.marginalized:
                    continue
                t, s = var_slot[v]
                var_masks[t][s] = 1.0
                touched[t][s] = 1.0
                if restrict_subtree:
                    mf = bp.msg_factor[t][s]
                    for k in range(bp.kmax[t]):
                        fl = mf[k]
                        if fl and (fl in allowed):
                            msg_masks[t][s, k] = 1.0
        return var_masks, msg_masks

    seq = 0
    # upsolve: deepest level first, messages restricted to subtree factors
    for level in reversed(tree.levels):
        sel = [ci for ci in level if ci in dirty]
        if not sel:
            continue
        vm, mm = level_masks(sel, restrict_subtree=restrict_subtree)
        beliefs = solver.sweep(
            beliefs, jax.random.fold_in(key, 10000 + seq), vm, mm
        )
        seq += 1
    # downsolve: root outward, full message sets (parent info included)
    if downsolve:
        for level in tree.levels:
            sel = [ci for ci in level if ci in dirty]
            if not sel:
                continue
            vm, mm = level_masks(sel, restrict_subtree=False)
            beliefs = solver.sweep(
                beliefs, jax.random.fold_in(key, 50000 + seq), vm, mm
            )
            seq += 1

    solver.scatter_beliefs(beliefs)
    # surface means only for variables the schedule actually updated —
    # recycled cliques keep beliefs AND point estimates bit-identical
    for t in ga.type_names:
        man = ga.manifolds[t]
        upd_slots = np.nonzero(touched[t] * np.asarray(ga.free[t]))[0]
        if len(upd_slots) == 0:
            continue
        mus = jax.vmap(lambda p: manifold_mean(man, p))(
            beliefs[t][jnp.asarray(upd_slots)]
        )
        mus = np.asarray(mus, dtype=np.float64)
        for i, s in enumerate(upd_slots):
            lbl = ga.var_labels[t][int(s)]
            rec = fg.variables[lbl]
            rec.points[solve_key] = mus[i]
            rec.initialized[solve_key] = True


# reference-style aliases
getEliminationOrder = get_elimination_order
buildTreeFromOrdering = build_tree_from_ordering
solveTree = solve_tree
calcCliquesRecycled = calc_cliques_recycled
