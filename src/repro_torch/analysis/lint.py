"""reprolint: static invariant checks for the fenced, batched control plane
(a copy of `repro.analysis.lint`: the same rules, fix-its, waiver syntax
and findings, pointed at the port's tree by ``tools/reprolint_torch.py``).

The runtime is correct and fast through *disciplines* that the code alone
does not enforce:

  * every authoritative ``sched/`` mutation is an epoch-compared KV
    transaction (``eval``/``eval_many``/``cas``/``incr``), never a bare
    ``set``/``delete`` — zombies must lose every race;
  * every fan-out goes through the batched verbs (``mget``/``mset``/
    ``eval_many``/``put_many``/``get_many``/``exists_many``) — request
    count, not bandwidth, is the bottleneck the paper measures.
    The wire tier's shard-map client surface is held to the same discipline: a
    constant ``kv.``/``ob.`` op through the raw wire verbs
    (``.call``/``.cast``/``.call_rid``) in a loop is the same N-round-trip
    mistake, and a fenced op name (``kv.set`` on ``sched/``) through the
    wire verb is the same fence violation — only the pipelined
    ``start_call``/``finish_call`` scatter and per-key ``watch.*``
    registration are sanctioned;
  * no blocking call (sleep, wait, KV/store round-trip, file I/O) runs
    while a lock is held — the shard condition-wait idiom is the one
    sanctioned exception because ``Condition.wait`` releases its lock;
  * waiting is event-driven (shard watch / store watch), never a naked
    ``time.sleep`` polling loop;
  * GC writes its tombstone *before* the batched delete, so a concurrent
    writer observes the tombstone instead of resurrecting freed state.

Each rule carries an ID and a fix-it message, and can be waived per line
with an inline escape hatch (same line or the line directly above)::

    # reprolint: disable=RULE001(reason why this site is deliberate)

``lint_source`` / ``lint_path`` / ``lint_tree`` return every
:class:`Finding`, suppressed ones flagged via ``Finding.disabled`` so the
CLI (``tools/reprolint_torch.py``) can hold the disable count against a
baseline file: invariant waivers are allowed to exist but not to grow
silently.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Set, Tuple

# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

RULES: Dict[str, str] = {
    "FENCE001": (
        "direct write to the fenced 'sched/' keyspace — authoritative "
        "scheduler state only moves through epoch-compared transactions"
    ),
    "BATCH001": (
        "per-key KV/store round-trip inside a loop — request count is the "
        "bottleneck; one batched call replaces N round-trips"
    ),
    "LOCK001": (
        "blocking call while a lock is held — lock scopes must only touch "
        "local state (Condition.wait is the sanctioned exception)"
    ),
    "EVENT001": (
        "naked time.sleep polling loop — the control plane is event-driven; "
        "wait on a shard/store watch instead"
    ),
    "GC001": (
        "batched delete of shared job state without a preceding tombstone "
        "write in the same function — zombies could resurrect freed keys"
    ),
}

FIXITS: Dict[str, str] = {
    "FENCE001": "use kv.eval/eval_many (epoch-compared CAS), kv.cas, or "
    "kv.incr; bare writes belong only in the blessed Scheduler helpers "
    "(Scheduler.finish_job's tombstone-then-GC path)",
    "BATCH001": "hoist out of the loop and batch: mget/mset/eval_many/"
    "rpush_many (KV) or get_many/put_many/exists_many/delete_many (store)",
    "LOCK001": "move the blocking call outside the `with <lock>` scope, or "
    "wait on a Condition built over the same lock",
    "EVENT001": "block on kv.wait_key/blpop or store.wait_put/wait_keys; "
    "polling belongs only in the watcher fallback (_PollWatcher)",
    "GC001": "write the GC tombstone (sched/finished/ or shuffle-gc/) "
    "before the batched delete, as shuffle.delete_intermediates does",
}

# The one place bare sched/ writes are part of the protocol: finish_job
# writes the sched/finished/ tombstone (idempotent marker, not fenced
# state) and then batch-deletes the job's keys behind it.
_FENCE_BLESSED: Set[Tuple[str, str]] = {("core/scheduler.py", "Scheduler.finish_job")}

_SCHED_PREFIX = "sched/"
# The job-manifest keyspace (core/jobs.py) gets a manifest-specific FENCE001
# message: its blessed mutation paths are jobs.commit_records (first-writer-
# wins eval_many) for manifest/stage/barrier records and the term-compared
# driver-lease evals — plus the same tombstone-then-GC finish_job path.
_JOB_PREFIX = "sched/job/"
_GC_PREFIXES = ("shuffle/", "result/", "input/")
_TOMBSTONE_PREFIXES = ("sched/finished/", "shuffle-gc/")

# Per-key verbs that have a batched counterpart (BATCH001).
_KV_PERKEY = {"get", "set", "rpush", "eval", "delete", "exists"}
_STORE_PERKEY = {
    "put", "get", "exists", "delete",
    "put_bytes", "get_bytes", "publish_result",
}
_BATCH_SUGGEST = {
    "get": "mget / get_many",
    "set": "mset / put_many",
    "rpush": "rpush_many",
    "eval": "eval_many",
    "delete": "mdel / delete_many",
    "exists": "exists_many",
    "put": "put_many",
    "put_bytes": "put_many_bytes",
    "get_bytes": "get_many_bytes",
    "publish_result": "put_many(..., if_absent=True)",
}

# The raw wire surface of the repro-kvd client (net_kv).  A constant
# "kv."/"ob." op through .call/.cast/.call_rid is the same round-trip the
# kv/store verbs wrap, so BATCH001 and FENCE001 see through it.
# `start_call`/`finish_call` are the sanctioned scatter half of a
# shard-map fan-out (N daemons in flight at once, not N serialized
# round-trips) and are never flagged; `watch.*` registration is per-key
# by protocol (refcounted, one op per wait session).
_WIRE_VERBS = {"call", "cast", "call_rid"}
_WIRE_PLANES = ("kv.", "ob.")
_WIRE_FENCED_OPS = {"kv.set", "kv.mset", "kv.delete", "kv.mdel"}

# Every KV/store method that is a storage round-trip (LOCK001).
_ROUNDTRIP_METHODS = {
    "get", "set", "mget", "mset", "setnx", "incr", "cas", "delete", "mdel",
    "exists", "scan", "eval", "eval_many", "rpush", "rpush_many", "lpop",
    "lpop_n", "blpop", "lrange", "llen", "put", "put_bytes", "put_many",
    "put_many_bytes", "get_bytes", "get_many", "get_many_bytes",
    "exists_many", "delete_many", "delete_prefix", "list", "publish_result",
}
_WAIT_METHODS = {"blpop", "wait_key", "wait_keys", "wait_put"}

# Batched delete verbs GC001 watches.
_GC_DELETE_METHODS = {"mdel", "delete_many", "delete_prefix"}
# Write verbs that can plant a tombstone.
_TOMBSTONE_WRITE_METHODS = {"set", "put", "put_bytes", "mset", "put_many"}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    fixit: str = ""
    disabled: bool = False
    disable_reason: str = ""

    def format(self) -> str:
        tag = " [disabled: %s]" % (self.disable_reason or "no reason") if self.disabled else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}{tag}"


# ---------------------------------------------------------------------------
# disable-comment parsing
# ---------------------------------------------------------------------------

_DISABLE_ITEM = re.compile(r"([A-Z]+\d+)\s*(?:\(([^)]*)\))?")
_DISABLE_RE = re.compile(r"#\s*reprolint:\s*disable=(.+)$")


def _parse_disables(source: str) -> Dict[int, Dict[str, str]]:
    """Map line number -> {rule: reason} for every disable annotation.
    An annotation covers its own line; a comment-only line also covers the
    next line (the common above-the-statement placement)."""
    out: Dict[int, Dict[str, str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(line)
        if not m:
            continue
        rules = {r: (reason or "").strip() for r, reason in _DISABLE_ITEM.findall(m.group(1))}
        if not rules:
            continue
        out.setdefault(lineno, {}).update(rules)
        if line.lstrip().startswith("#"):
            out.setdefault(lineno + 1, {}).update(rules)
    return out


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------

def _name_chain(node: ast.AST) -> List[str]:
    """``self.kv.set`` -> ["self", "kv", "set"]; unresolvable roots -> "?"."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return list(reversed(parts))


def _receiver_kind(recv_leaf: str) -> Optional[str]:
    """Classify a call receiver by its trailing identifier."""
    if recv_leaf == "kv" or recv_leaf.endswith("_kv"):
        return "kv"
    if recv_leaf == "store" or recv_leaf.endswith("store"):
        return "store"
    if recv_leaf == "backend":
        return "backend"
    return None


def _is_lockish_name(leaf: str) -> bool:
    return leaf == "lock" or leaf.endswith("lock") or leaf == "cond"


def _is_condish(leaf: str) -> bool:
    return leaf == "cond" or leaf.endswith("cond") or leaf.endswith("condition")


class _FileLinter(ast.NodeVisitor):
    def __init__(self, source: str, path: str) -> None:
        self.source = source
        self.path = path.replace(os.sep, "/")
        self.findings: List[Finding] = []
        self.consts: Dict[str, str] = {}  # module-level string constants
        self.class_stack: List[str] = []
        self.func_stack: List[dict] = []  # {name, tombstone, acquired:set}
        self.loop_depth = 0
        self.while_depth = 0
        self.lock_stack: List[str] = []  # descriptions of held `with` locks
        self.disables = _parse_disables(source)

    # -- entry ----------------------------------------------------------
    def run(self) -> List[Finding]:
        tree = ast.parse(self.source, filename=self.path)
        # First pass: module-level string constants (key-prefix resolution).
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name) and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    self.consts[tgt.id] = node.value.value
        self.visit(tree)
        return self.findings

    # -- reporting ------------------------------------------------------
    def _report(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        col = getattr(node, "col_offset", 0)
        here = self.disables.get(line, {})
        disabled = rule in here
        self.findings.append(
            Finding(
                rule=rule,
                path=self.path,
                line=line,
                col=col,
                message=message,
                fixit=FIXITS[rule],
                disabled=disabled,
                disable_reason=here.get(rule, ""),
            )
        )

    # -- prefix resolution ----------------------------------------------
    def _resolve_prefix(self, node: Optional[ast.AST]) -> Optional[str]:
        """Best-effort static string prefix of a key expression."""
        if node is None:
            return None
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.consts.get(node.id)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            return self._resolve_prefix(node.left)
        if isinstance(node, ast.JoinedStr) and node.values:
            first = node.values[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                return first.value
        return None

    def _iter_key_exprs(self, arg: Optional[ast.AST]) -> Iterator[ast.AST]:
        """Key expressions reachable in a keys/mapping argument."""
        if arg is None:
            return
        if isinstance(arg, (ast.List, ast.Tuple, ast.Set)):
            yield from arg.elts
        elif isinstance(arg, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            yield arg.elt
        elif isinstance(arg, ast.Dict):
            for k in arg.keys:
                if k is not None:
                    yield k
        elif isinstance(arg, ast.DictComp):
            yield arg.key
        elif isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
            yield from self._iter_key_exprs(arg.left)
            yield from self._iter_key_exprs(arg.right)
        else:
            yield arg

    def _key_prefixes(self, arg: Optional[ast.AST]) -> List[str]:
        out = []
        for expr in self._iter_key_exprs(arg):
            p = self._resolve_prefix(expr)
            if p is not None:
                out.append(p)
        return out

    # -- context tracking ------------------------------------------------
    def _qualname(self) -> str:
        names = list(self.class_stack)
        names += [f["name"] for f in self.func_stack]
        return ".".join(names)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def _visit_func(self, node) -> None:
        # A nested def/lambda body does not run under the enclosing
        # function's lexical locks (it runs when called), so reset the
        # blocking-context stacks for its body.
        saved = (self.loop_depth, self.while_depth, self.lock_stack)
        self.loop_depth, self.while_depth, self.lock_stack = 0, 0, []
        self.func_stack.append({"name": node.name, "tombstone": False, "acquired": []})
        self.generic_visit(node)
        self.func_stack.pop()
        self.loop_depth, self.while_depth, self.lock_stack = saved

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.target)
        self.visit(node.iter)
        self.loop_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self.loop_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        self.loop_depth += 1
        self.while_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        self.loop_depth -= 1
        self.while_depth -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    def _visit_comp(self, node) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            desc = self._lock_desc(item.context_expr)
            if desc is not None:
                self.lock_stack.append(desc)
                pushed += 1
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.lock_stack.pop()

    def _lock_desc(self, expr: ast.AST) -> Optional[str]:
        """Is this `with` context a lock scope? Knows attribute locks
        (`self._lock`, `sh.lock`), bare Lock()/RLock()/Condition()
        constructions, and the FileKVStore flock transaction helper
        (`self._txn(...)` = shard thread lock + cross-process flock)."""
        if isinstance(expr, (ast.Attribute, ast.Name)):
            chain = _name_chain(expr)
            if _is_lockish_name(chain[-1]):
                return ".".join(chain)
        if isinstance(expr, ast.Call):
            chain = _name_chain(expr.func)
            if chain[-1] in ("Lock", "RLock", "Condition"):
                return f"{chain[-1]}()"
            if chain[-1] == "_txn":
                return "_txn (shard lock + flock)"
        return None

    def visit_Expr(self, node: ast.Expr) -> None:
        # Track bare X.acquire()/X.release() statements: the scope between
        # them is a held-lock region for the rest of this function body.
        call = node.value
        if isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute):
            chain = _name_chain(call.func)
            recv = ".".join(chain[:-1])
            if chain[-1] == "acquire" and self.func_stack and _is_lockish_name(
                chain[-2] if len(chain) >= 2 else ""
            ):
                self.func_stack[-1]["acquired"].append(recv)
            elif chain[-1] == "release" and self.func_stack:
                acq = self.func_stack[-1]["acquired"]
                if recv in acq:
                    acq.remove(recv)
        self.generic_visit(node)

    # -- the rules -------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        chain = _name_chain(func)
        method = chain[-1]
        recv_leaf = chain[-2] if len(chain) >= 2 else ""
        kind = _receiver_kind(recv_leaf) if len(chain) >= 2 else None

        self._check_fence(node, method, kind)
        self._check_batch(node, method, kind)
        self._check_lock(node, chain, method, recv_leaf, kind)
        self._check_event(node, chain)
        self._check_gc(node, method, kind)
        self._note_tombstone(node, method, kind)

        self.generic_visit(node)

    # FENCE001 ----------------------------------------------------------
    def _check_fence(self, node: ast.Call, method: str, kind: Optional[str]) -> None:
        verb: Optional[str] = None
        key_arg: Optional[ast.AST] = None
        if kind == "kv" and method in ("set", "delete", "mset", "mdel"):
            verb = f"kv.{method}"
            key_arg = node.args[0] if node.args else None
        elif method in ("call", "cast"):
            # The same write reaching the daemon through the raw wire verb
            # bypasses nothing: sched/ stays fenced on every surface.
            op = self._resolve_prefix(node.args[0] if node.args else None)
            if op in _WIRE_FENCED_OPS:
                verb = f'{op} (via .{method})'
                key_arg = node.args[1] if len(node.args) >= 2 else None
        if verb is None:
            return
        prefixes = self._key_prefixes(key_arg)
        if not any(p.startswith(_SCHED_PREFIX) for p in prefixes):
            return
        qual = self._qualname()
        for mod, blessed_qual in _FENCE_BLESSED:
            if self.path.endswith(mod) and qual.startswith(blessed_qual):
                return
        if any(p.startswith(_JOB_PREFIX) for p in prefixes):
            self._report(
                "FENCE001",
                node,
                f"bare {verb} on the job-manifest keyspace "
                f"(prefix {prefixes[0]!r}) — manifest/stage/barrier records "
                "move only through jobs.commit_records (first-writer-wins "
                "eval_many) and the driver lease only through term-compared "
                "evals (jobs.acquire_driver/heartbeat_drivers/release_driver); "
                "deletion only behind Scheduler.finish_job's tombstone",
            )
            return
        self._report(
            "FENCE001",
            node,
            f"bare {verb} on the fenced 'sched/' keyspace "
            f"(prefix {prefixes[0]!r}) — {RULES['FENCE001']}. Fix: {FIXITS['FENCE001']}",
        )

    # BATCH001 ----------------------------------------------------------
    def _check_batch(self, node: ast.Call, method: str, kind: Optional[str]) -> None:
        if self.loop_depth == 0:
            return
        if method in _WIRE_VERBS:
            # One blocking .call per iteration serializes the round-trips
            # the shard map exists to overlap.  watch.* is per-key by
            # protocol; start_call/finish_call (not in _WIRE_VERBS) are
            # the sanctioned pipelined scatter.
            op = self._resolve_prefix(node.args[0] if node.args else None)
            if op is None or not op.startswith(_WIRE_PLANES):
                return
            self._report(
                "BATCH001",
                node,
                f"raw wire .{method}({op!r}) inside a loop — "
                f"{RULES['BATCH001']}. Fix: pipeline the scatter with "
                "start_call/finish_call across daemons, or use the "
                "batched op",
            )
            return
        if kind == "kv" and method in _KV_PERKEY:
            pass
        elif kind in ("store", "backend") and method in _STORE_PERKEY:
            pass
        else:
            return
        suggest = _BATCH_SUGGEST.get(method, "a batched verb")
        self._report(
            "BATCH001",
            node,
            f"per-key .{method} inside a loop — {RULES['BATCH001']}. "
            f"Fix: use {suggest} outside the loop",
        )

    # LOCK001 -----------------------------------------------------------
    def _in_lock_scope(self) -> Optional[str]:
        if self.lock_stack:
            return self.lock_stack[-1]
        if self.func_stack and self.func_stack[-1]["acquired"]:
            return self.func_stack[-1]["acquired"][-1] + " (acquired)"
        return None

    def _check_lock(
        self,
        node: ast.Call,
        chain: List[str],
        method: str,
        recv_leaf: str,
        kind: Optional[str],
    ) -> None:
        held = self._in_lock_scope()
        if held is None:
            return
        blocker: Optional[str] = None
        if chain[-2:] == ["time", "sleep"] or (len(chain) == 1 and method == "sleep"):
            blocker = "time.sleep"
        elif method in _WAIT_METHODS:
            blocker = f".{method}"
        elif method == "wait" and not _is_condish(recv_leaf):
            # Condition.wait releases its lock — the sanctioned idiom; an
            # Event/other .wait under a lock genuinely blocks.
            blocker = ".wait"
        elif kind is not None and method in _ROUNDTRIP_METHODS:
            blocker = f"{kind} round-trip .{method}"
        elif chain[-2:] in (["os", "fsync"], ["os", "sync"]):
            blocker = ".".join(chain)
        elif len(chain) == 1 and method == "open":
            blocker = "open()"
        elif chain[-2:] == ["fcntl", "flock"]:
            # LOCK_UN never blocks; LOCK_EX/LOCK_SH can.
            if not (
                len(node.args) >= 2
                and isinstance(node.args[1], ast.Attribute)
                and node.args[1].attr == "LOCK_UN"
            ):
                blocker = "fcntl.flock"
        if blocker is None:
            return
        self._report(
            "LOCK001",
            node,
            f"{blocker} while holding {held} — {RULES['LOCK001']}. "
            f"Fix: {FIXITS['LOCK001']}",
        )

    # EVENT001 ----------------------------------------------------------
    def _check_event(self, node: ast.Call, chain: List[str]) -> None:
        if self.while_depth == 0:
            return
        if not (chain[-2:] == ["time", "sleep"] or chain == ["sleep"]):
            return
        # The watcher fallback is the one module allowed to poll (it IS the
        # poll-to-event converter); inotify backoff likewise.
        if any("Watcher" in c for c in self.class_stack):
            return
        if self.path.endswith("storage/inotify.py"):
            return
        self._report(
            "EVENT001",
            node,
            f"time.sleep inside a while loop — {RULES['EVENT001']}. "
            f"Fix: {FIXITS['EVENT001']}",
        )

    # GC001 -------------------------------------------------------------
    def _note_tombstone(self, node: ast.Call, method: str, kind: Optional[str]) -> None:
        if not self.func_stack or method not in _TOMBSTONE_WRITE_METHODS:
            return
        arg = node.args[0] if node.args else None
        for expr in self._iter_key_exprs(arg):
            p = self._resolve_prefix(expr)
            if p is not None and p.startswith(_TOMBSTONE_PREFIXES):
                self.func_stack[-1]["tombstone"] = True
                return
            # `store.set(gc_tombstone_key(job), 1)`: the helper names itself.
            target = expr
            if isinstance(target, ast.BinOp) and isinstance(target.op, ast.Add):
                target = target.left
            if isinstance(target, ast.Call):
                fchain = _name_chain(target.func)
                if "tombstone" in fchain[-1]:
                    self.func_stack[-1]["tombstone"] = True
                    return

    def _check_gc(self, node: ast.Call, method: str, kind: Optional[str]) -> None:
        if kind is None or method not in _GC_DELETE_METHODS:
            return
        arg = node.args[0] if node.args else None
        prefixes = self._key_prefixes(arg)
        hit = [p for p in prefixes if p.startswith(_GC_PREFIXES)]
        if not hit:
            return
        if self.func_stack and self.func_stack[-1]["tombstone"]:
            return
        self._report(
            "GC001",
            node,
            f"batched .{method} on {hit[0]!r} with no earlier tombstone "
            f"write in this function — {RULES['GC001']}. Fix: {FIXITS['GC001']}",
        )


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one source string; returns every finding (disabled included)."""
    return _FileLinter(source, path).run()


def lint_path(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_tree(root: str) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (or a single file)."""
    if os.path.isfile(root):
        return lint_path(root)
    findings: List[Finding] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if name.endswith(".py"):
                findings.extend(lint_path(os.path.join(dirpath, name)))
    return findings


def active(findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if not f.disabled]


def disabled_counts(findings: List[Finding]) -> Dict[str, int]:
    """Suppressed-finding tally per rule (the baseline currency)."""
    out: Dict[str, int] = {}
    for f in findings:
        if f.disabled:
            out[f.rule] = out.get(f.rule, 0) + 1
    return out
