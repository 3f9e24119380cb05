"""Lower PhysicalExpr trees to traceable device functions.

The host path evaluates expressions batch-at-a-time in numpy
(`physical/expressions.py`); this module compiles the same trees into
closures traceable under `jax.jit`, so whole operator pipelines fuse into
one XLA program.

Dictionary-encoded strings: per-row work happens on int32 codes; anything
that needs the dictionary itself (literal lookup, LIKE, IN-list) is
resolved on the host *per batch* into auxiliary scalar/LUT inputs of the
jitted function (`AuxSpec`). The jitted program never sees a string.

Unsupported constructs raise `LoweringError`; callers fall back to the
host path.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from ..common.datatypes import TypeId
from ..expr.operator import Op
from ..physical import expressions as PE
from ..physical import kernels as K


class LoweringError(Exception):
    pass


class AuxSpec:
    """One host-computed input to the jitted program (per batch)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn          # batch -> np scalar or np array
        self.name = name


class Lowered:
    """Result of lowering: `trace(cols, valids, aux) -> (data, valid)`
    where cols/valids are the input batch's device arrays (by column
    index), aux is the list of prepared auxiliary arrays."""

    def __init__(self, trace, aux: List[AuxSpec], out_dtype):
        self.trace = trace
        self.aux = aux
        self.out_dtype = out_dtype


def _jnp():
    import jax.numpy as jnp
    return jnp


def lower_expr(e: PE.PhysicalExpr, input_batch_probe=None) -> Lowered:
    """Compile a physical expression into a traceable closure."""
    aux: List[AuxSpec] = []
    trace = _lower(e, aux)
    return Lowered(trace, aux, e.out_type)


def _aux(aux_list: List[AuxSpec], fn, name: str) -> int:
    aux_list.append(AuxSpec(fn, name))
    return len(aux_list) - 1


def _lower(e: PE.PhysicalExpr, aux: List[AuxSpec]):
    jnp = _jnp()

    if isinstance(e, PE.ColumnExpr):
        if e.out_type.is_wide_decimal or (
                e.out_type.is_interval and
                not (e.out_type.unit or "").startswith("rawdur")):
            raise LoweringError("object-storage column stays on host")
        idx = e.index

        def t(cols, valids, a):
            return cols[idx], valids[idx]
        return t

    if isinstance(e, PE.LiteralExpr):
        sv = e.value
        if sv.dtype.is_string:
            raise LoweringError("bare string literal outside comparison")
        if sv.value is None:
            def t(cols, valids, a, _d=sv.dtype):
                n = cols[0].shape[0]
                return (jnp.zeros(n, _d.device_dtype()), jnp.zeros(n, bool))
            return t
        v = sv.device_value()

        def t(cols, valids, a, _v=v):
            n = cols[0].shape[0]
            return jnp.full(n, _v), None
        return t

    if isinstance(e, PE.DeferredScalarExpr):
        # uncorrelated scalar subquery: value arrives as an AUX INPUT of
        # the compiled program (fresh each execution, no recompile)
        if e.out_type.is_string:
            raise LoweringError("string scalar subquery on device TBD")
        npdt = e.out_type.device_dtype()
        ai = _aux(aux, lambda b, _e=e, _d=npdt: np.asarray(
            [_e.scalar()[0]], _d), "scalar_subquery")
        av = _aux(aux, lambda b, _e=e: np.asarray(
            [_e.scalar()[1]], np.bool_), "scalar_subquery_valid")

        def t(cols, valids, a, _ai=ai, _av=av):
            n = cols[0].shape[0]
            d = jnp.broadcast_to(a[_ai][0], (n,))
            v = jnp.broadcast_to(a[_av][0], (n,))
            return d, v
        return t

    if isinstance(e, PE.BinaryPhysExpr):
        return _lower_binary(e, aux)

    if isinstance(e, PE.CastExpr):
        inner = _lower(e.expr, aux)
        frm, to = e.expr.out_type, e.out_type
        if frm.is_string or to.is_string:
            raise LoweringError("string casts stay on host")
        if frm.is_decimal or to.is_decimal:
            if frm.is_decimal and to.is_decimal and frm.scale == to.scale:
                def t(cols, valids, a):
                    return inner(cols, valids, a)
                return t
            raise LoweringError("decimal rescale cast on device TBD")
        npdt = to.device_dtype()

        def t(cols, valids, a):
            d, v = inner(cols, valids, a)
            return d.astype(npdt), v
        return t

    if isinstance(e, PE.NotExpr):
        inner = _lower(e.expr, aux)

        def t(cols, valids, a):
            d, v = inner(cols, valids, a)
            return ~d, v
        return t

    if isinstance(e, PE.NegativeExpr):
        inner = _lower(e.expr, aux)

        def t(cols, valids, a):
            d, v = inner(cols, valids, a)
            return -d, v
        return t

    if isinstance(e, PE.IsNullExpr):
        inner = _lower(e.expr, aux)
        negated = e.negated

        def t(cols, valids, a):
            d, v = inner(cols, valids, a)
            m = jnp.ones(d.shape[0], bool) if v is None else v
            return (m if negated else ~m), None
        return t

    if isinstance(e, PE.CaseExpr):
        if e.operand is not None:
            raise LoweringError("CASE <operand> lowering TBD")
        whens = [( _lower(w, aux), _lower(th, aux)) for w, th in e.whens]
        else_t = _lower(e.else_, aux) if e.else_ is not None else None
        out_np = e.out_type.device_dtype()

        def t(cols, valids, a):
            n = cols[0].shape[0]
            if else_t is not None:
                acc, accv = else_t(cols, valids, a)
                acc = acc.astype(out_np)
            else:
                acc, accv = jnp.zeros(n, out_np), jnp.zeros(n, bool)
            accv = jnp.ones(n, bool) if accv is None else accv
            taken = jnp.zeros(n, bool)
            for wt, tt in whens:
                wd, wv = wt(cols, valids, a)
                cond = wd & (jnp.ones(n, bool) if wv is None else wv) & ~taken
                td, tv = tt(cols, valids, a)
                acc = jnp.where(cond, td.astype(out_np), acc)
                accv = jnp.where(cond,
                                 jnp.ones(n, bool) if tv is None else tv, accv)
                taken = taken | cond
            return acc, accv
        return t

    if isinstance(e, PE.InListExpr):
        return _lower_inlist(e, aux)

    if isinstance(e, PE.LikeExpr):
        return _lower_like(e, aux)

    if isinstance(e, PE.ScalarFunctionExpr):
        return _lower_function(e, aux)

    raise LoweringError(f"cannot lower {type(e).__name__}")


def _and_valid(jnp, *vs):
    out = None
    for v in vs:
        if v is None:
            continue
        out = v if out is None else (out & v)
    return out


def _string_literal_of(e: PE.PhysicalExpr) -> Optional[str]:
    if isinstance(e, PE.LiteralExpr) and e.value.dtype.is_string:
        return e.value.value
    return None


def _col_of(e: PE.PhysicalExpr) -> Optional[PE.ColumnExpr]:
    return e if isinstance(e, PE.ColumnExpr) else None


def _lower_binary(e: PE.BinaryPhysExpr, aux):
    jnp = _jnp()
    op = e.op
    lt, rt = e.left.out_type, e.right.out_type

    # string column <cmp> string literal: resolve literal to code bounds per
    # batch (sorted dictionary -> binary search)
    if op in (Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ) and \
            (lt.is_string or rt.is_string):
        col, lit, flipped = None, None, False
        if _col_of(e.left) is not None and _string_literal_of(e.right) is not None:
            col, lit = e.left, _string_literal_of(e.right)
        elif _col_of(e.right) is not None and _string_literal_of(e.left) is not None:
            col, lit, flipped = e.right, _string_literal_of(e.left), True
        if col is None:
            raise LoweringError("string comparison needs column vs literal")
        idx = col.index
        if flipped:
            op = {Op.LT: Op.GT, Op.LTEQ: Op.GTEQ, Op.GT: Op.LT,
                  Op.GTEQ: Op.LTEQ}.get(op, op)

        def prep(batch, _i=idx, _s=lit):
            dic = batch.columns[_i].dictionary
            # position of the literal in sorted dictionary space
            pos = int(np.searchsorted(dic.values.astype(str), _s, side="left"))
            exact = dic.lookup(_s)
            return np.array([pos, exact], np.int64)
        ai = _aux(aux, prep, f"strlit:{lit}")
        _op = op

        def t(cols, valids, a):
            codes = cols[idx]
            pos, exact = a[ai][0], a[ai][1]
            if _op == Op.EQ:
                d = codes.astype(jnp.int64) == exact
            elif _op == Op.NEQ:
                d = codes.astype(jnp.int64) != exact
            elif _op == Op.LT:
                d = codes.astype(jnp.int64) < pos
            elif _op == Op.LTEQ:
                # <=: codes < pos, or == exact when present
                d = (codes.astype(jnp.int64) < pos) | \
                    (codes.astype(jnp.int64) == exact)
            elif _op == Op.GT:
                d = (codes.astype(jnp.int64) >= pos) & \
                    (codes.astype(jnp.int64) != exact)
            else:  # GTEQ
                d = codes.astype(jnp.int64) >= pos
            return d, valids[idx]
        return t

    # decimal column <cmp> float literal: descaling to f64 on device can
    # drift by ~1 ulp and boundary rows vanish (l_discount >= 0.05 would
    # drop 0.05). The literal is static: compute the exact scaled-int
    # threshold on the host (true f64, matching the reference's
    # decimal->double coercion), and compare integers on device.
    if op in (Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
        dec_side = lit_side = None
        if lt.is_decimal and isinstance(e.right, PE.LiteralExpr) and \
                rt.is_float and e.right.value.value is not None:
            dec_side, lit_side, flip = e.left, e.right, False
        elif rt.is_decimal and isinstance(e.left, PE.LiteralExpr) and \
                lt.is_float and e.left.value.value is not None:
            dec_side, lit_side, flip = e.right, e.left, True
        if dec_side is not None:
            scale = 10 ** dec_side.out_type.scale
            lit = np.float64(lit_side.value.value)
            inner = _lower(dec_side, aux)
            op_ = op
            if flip:
                op_ = {Op.LT: Op.GT, Op.GT: Op.LT, Op.LTEQ: Op.GTEQ,
                       Op.GTEQ: Op.LTEQ}.get(op_, op_)
            # minimal s with f64(s/scale) >= lit / > lit (f64(s/scale) is
            # monotone in s); scan the exact neighborhood in host f64
            c = int(np.floor(float(lit) * scale)) - 2
            while np.float64(c) / np.float64(scale) < lit:
                c += 1
            t_ge = c            # min s with value >= lit
            c2 = t_ge
            while np.float64(c2) / np.float64(scale) <= lit:
                c2 += 1
            t_gt = c2           # min s with value > lit

            def t(cols, valids, a):
                d, v = inner(cols, valids, a)
                s = d.astype(jnp.int64)
                if op_ == Op.GTEQ:
                    out = s >= t_ge
                elif op_ == Op.GT:
                    out = s >= t_gt
                elif op_ == Op.LT:
                    out = s < t_ge
                elif op_ == Op.LTEQ:
                    out = s < t_gt
                elif op_ == Op.EQ:
                    out = (s >= t_ge) & (s < t_gt)
                else:
                    out = (s < t_ge) | (s >= t_gt)
                return out, v
            return t

    # decimal column <cmp> float SCALAR SUBQUERY: same exact-threshold
    # trick as the literal case above, but the thresholds are computed in
    # an aux fn at execution time (host f64) and enter the compiled
    # program as inputs — fresh value every query, no recompile.
    if op in (Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
        dec_side = sc_side = None
        if lt.is_decimal and isinstance(e.right, PE.DeferredScalarExpr) \
                and rt.is_float:
            dec_side, sc_side, flip = e.left, e.right, False
        elif rt.is_decimal and isinstance(e.left, PE.DeferredScalarExpr) \
                and lt.is_float:
            dec_side, sc_side, flip = e.right, e.left, True
        if dec_side is not None:
            scale = 10 ** dec_side.out_type.scale
            inner = _lower(dec_side, aux)
            op_ = op
            if flip:
                op_ = {Op.LT: Op.GT, Op.GT: Op.LT, Op.LTEQ: Op.GTEQ,
                       Op.GTEQ: Op.LTEQ}.get(op_, op_)

            def thresholds(_b, _s=sc_side, _scale=scale):
                val, valid, _ = _s.scalar()
                if not valid:
                    return np.array([0, 0, 0], np.int64)
                lit = np.float64(val)
                c = int(np.floor(float(lit) * _scale)) - 2
                while np.float64(c) / np.float64(_scale) < lit:
                    c += 1
                t_ge = c
                c2 = t_ge
                while np.float64(c2) / np.float64(_scale) <= lit:
                    c2 += 1
                return np.array([t_ge, c2, 1], np.int64)

            ai = _aux(aux, thresholds, "dec_scalar_thresholds")

            def t(cols, valids, a, _ai=ai, _op=op_):
                d, v = inner(cols, valids, a)
                s = d.astype(jnp.int64)
                t_ge, t_gt = a[_ai][0], a[_ai][1]
                if _op == Op.GTEQ:
                    out = s >= t_ge
                elif _op == Op.GT:
                    out = s >= t_gt
                elif _op == Op.LT:
                    out = s < t_ge
                elif _op == Op.LTEQ:
                    out = s < t_gt
                elif _op == Op.EQ:
                    out = (s >= t_ge) & (s < t_gt)
                else:
                    out = (s < t_ge) | (s >= t_gt)
                sv = jnp.broadcast_to(a[_ai][2] != 0, out.shape)
                return out, (sv if v is None else (v & sv))
            return t

    l = _lower(e.left, aux)
    r = _lower(e.right, aux)

    if op in (Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ):
        if lt.is_string or rt.is_string:
            raise LoweringError("string-string comparison on device TBD")
        common_t = K._comparison_type(lt, rt)
        common = common_t.device_dtype()
        fn = {Op.EQ: jnp.equal, Op.NEQ: jnp.not_equal,
              Op.LT: jnp.less, Op.LTEQ: jnp.less_equal,
              Op.GT: jnp.greater, Op.GTEQ: jnp.greater_equal}[op]

        _UNIT = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}

        def conv(arr, frm):
            # device representation conversion to the comparison type
            if frm.is_decimal and common_t.is_float:
                return arr.astype(common) / (10.0 ** frm.scale)
            if frm.is_decimal and common_t.is_decimal:
                ds = common_t.scale - frm.scale
                return arr.astype(jnp.int64) * (10 ** ds) if ds >= 0 else \
                    arr.astype(jnp.int64) // (10 ** (-ds))
            if common_t.is_decimal and not frm.is_decimal:
                return arr.astype(jnp.int64) * (10 ** common_t.scale)
            from ..common.datatypes import TypeId as _TId
            if common_t.id in (_TId.TIMESTAMP, _TId.TIME) and \
                    frm.id in (_TId.TIMESTAMP, _TId.TIME, _TId.DATE):
                fa = 86_400 * _UNIT[common_t.unit or "ns"] \
                    if frm.id == _TId.DATE else _UNIT[frm.unit or "ns"]
                fb = _UNIT[common_t.unit or "ns"]
                x = arr.astype(jnp.int64)
                if frm.id == _TId.DATE:
                    return x * fa
                return x * (fb // fa) if fb >= fa else x // (fa // fb)
            return arr.astype(common)

        def t(cols, valids, a):
            ld, lv = l(cols, valids, a)
            rd, rv = r(cols, valids, a)
            d = fn(conv(ld, lt), conv(rd, rt))
            return d, _and_valid(jnp, lv, rv)
        return t

    if op == Op.AND:
        def t(cols, valids, a):
            ld, lv = l(cols, valids, a)
            rd, rv = r(cols, valids, a)
            n = ld.shape[0]
            lv_ = jnp.ones(n, bool) if lv is None else lv
            rv_ = jnp.ones(n, bool) if rv is None else rv
            data = (ld | ~lv_) & (rd | ~rv_)
            valid = (lv_ & rv_) | (lv_ & ~ld) | (rv_ & ~rd)
            return data, valid
        return t

    if op == Op.OR:
        def t(cols, valids, a):
            ld, lv = l(cols, valids, a)
            rd, rv = r(cols, valids, a)
            n = ld.shape[0]
            lv_ = jnp.ones(n, bool) if lv is None else lv
            rv_ = jnp.ones(n, bool) if rv is None else rv
            tl = lv_ & ld
            tr = rv_ & rd
            return tl | tr, (lv_ & rv_) | tl | tr
        return t

    if op in (Op.PLUS, Op.MINUS, Op.MULTIPLY, Op.DIVIDE, Op.MODULO):
        out_t = e.out_type
        dec_scale_l = dec_scale_r = 0
        if out_t.is_decimal:
            # decimal arithmetic on scaled int64: rescale inputs so that
            # + and - meet at out scale, * sums the scales to out scale
            ls = lt.scale if lt.is_decimal else 0
            rs = rt.scale if rt.is_decimal else 0
            if op in (Op.PLUS, Op.MINUS):
                if ls > out_t.scale or rs > out_t.scale:
                    raise LoweringError("decimal downscale add on device TBD")
                dec_scale_l = out_t.scale - ls
                dec_scale_r = out_t.scale - rs
            elif op == Op.MULTIPLY:
                if ls + rs > out_t.scale:
                    raise LoweringError("decimal downscale mul on device TBD")
                # distribute the residual scale onto the left input
                dec_scale_l = out_t.scale - ls - rs
            else:
                raise LoweringError("decimal div/mod on device TBD")
        if lt.is_temporal or rt.is_temporal or lt.is_interval or rt.is_interval:
            raise LoweringError("temporal arithmetic on device TBD")
        npdt = out_t.device_dtype()

        def t(cols, valids, a):
            ld, lv = l(cols, valids, a)
            rd, rv = r(cols, valids, a)
            if out_t.is_decimal:
                ld = ld.astype(jnp.int64)
                rd = rd.astype(jnp.int64)
                if dec_scale_l:
                    ld = ld * (10 ** dec_scale_l)
                if dec_scale_r:
                    rd = rd * (10 ** dec_scale_r)
            else:
                # descale decimal inputs entering a float computation
                if lt.is_decimal and out_t.is_float:
                    ld = ld.astype(npdt) / (10.0 ** lt.scale)
                else:
                    ld = ld.astype(npdt)
                if rt.is_decimal and out_t.is_float:
                    rd = rd.astype(npdt) / (10.0 ** rt.scale)
                else:
                    rd = rd.astype(npdt)
            if op == Op.PLUS:
                d = ld + rd
            elif op == Op.MINUS:
                d = ld - rd
            elif op == Op.MULTIPLY:
                d = ld * rd
            elif op == Op.DIVIDE:
                if out_t.is_integer:
                    safe = jnp.where(rd == 0, 1, rd)
                    q = jnp.abs(ld) // jnp.abs(safe)
                    d = (jnp.sign(ld) * jnp.sign(safe) * q).astype(npdt)
                else:
                    d = ld / rd
            else:
                safe = jnp.where(rd == 0, 1, rd)
                # SQL %% truncates toward zero (fmod semantics)
                d = jnp.where(ld >= 0, ld % jnp.abs(safe),
                              -((-ld) % jnp.abs(safe)))
            return d.astype(npdt), _and_valid(jnp, lv, rv)
        return t

    raise LoweringError(f"cannot lower operator {op}")


def _lower_inlist(e: PE.InListExpr, aux):
    jnp = _jnp()
    col = _col_of(e.expr)
    if e.expr.out_type.is_string:
        if col is None:
            raise LoweringError("string IN needs a plain column")
        items = []
        for it in e.items:
            s = _string_literal_of(it)
            if s is None:
                raise LoweringError("string IN list must be literals")
            items.append(s)
        idx = col.index

        def prep(batch, _i=idx, _items=tuple(items)):
            dic = batch.columns[_i].dictionary
            lut = np.zeros(max(len(dic), 1), bool)
            for s in _items:
                code = dic.lookup(s)
                if code >= 0:
                    lut[code] = True
            return lut
        ai = _aux(aux, prep, "inlist_lut")
        negated = e.negated

        def t(cols, valids, a):
            codes = cols[idx]
            lut = a[ai]
            d = lut[jnp.clip(codes, 0, lut.shape[0] - 1)]
            if negated:
                d = ~d
            return d, valids[idx]
        return t

    inner = _lower(e.expr, aux)
    consts = []
    for it in e.items:
        if not isinstance(it, PE.LiteralExpr) or it.value.value is None:
            raise LoweringError("IN list must be non-null literals")
        consts.append(it.value.cast(e.expr.out_type).device_value())
    negated = e.negated

    def t(cols, valids, a):
        d, v = inner(cols, valids, a)
        hit = jnp.zeros(d.shape[0], bool)
        for c in consts:
            hit = hit | (d == c)
        return (~hit if negated else hit), v
    return t


def _lower_like(e: PE.LikeExpr, aux):
    jnp = _jnp()
    col = _col_of(e.expr)
    pat = _string_literal_of(e.pattern)
    if col is None or pat is None:
        raise LoweringError("LIKE needs column vs literal pattern")
    idx = col.index
    negated = e.negated
    ci = e.case_insensitive
    esc = e.escape

    def prep(batch, _i=idx, _p=pat):
        import re
        dic = batch.columns[_i].dictionary
        flags = re.DOTALL | (re.IGNORECASE if ci else 0)
        rx = re.compile(K.like_pattern_to_regex(_p, esc), flags)
        lut = np.fromiter((rx.match(s) is not None for s in dic.values),
                          dtype=bool, count=len(dic))
        return lut if len(lut) else np.zeros(1, bool)
    ai = _aux(aux, prep, f"like:{pat}")

    def t(cols, valids, a):
        codes = cols[idx]
        lut = a[ai]
        d = lut[jnp.clip(codes, 0, lut.shape[0] - 1)]
        if negated:
            d = ~d
        return d, valids[idx]
    return t


_MATH = {
    "abs": "abs", "sqrt": "sqrt", "exp": "exp", "ln": "log", "log2": "log2",
    "log10": "log10", "sin": "sin", "cos": "cos", "tan": "tan",
    "floor": "floor", "ceil": "ceil",
}


def _lower_function(e: PE.ScalarFunctionExpr, aux):
    jnp = _jnp()
    if e.name in _MATH and len(e.args) == 1:
        inner = _lower(e.args[0], aux)
        fname = _MATH[e.name]
        out_np = e.out_type.device_dtype()

        def t(cols, valids, a):
            d, v = inner(cols, valids, a)
            return getattr(jnp, fname)(d.astype(jnp.float64)).astype(out_np), v
        return t
    if e.name in ("date_part", "datepart") and len(e.args) == 2:
        return _lower_date_part(e, aux)
    raise LoweringError(f"function {e.name} not lowerable")


def _device_days_to_ymd(jnp, days):
    """Civil-from-days (Howard Hinnant's algorithm) as pure int64
    elementwise ops — the device twin of datetime_impl._days_to_ymd."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    dom = doy - (153 * mp + 2) // 5 + 1
    m = jnp.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2)
    return y, m, dom


def _device_ymd_to_days(jnp, y, m, dom):
    """days-from-civil (Hinnant), device twin of _ymd_to_days for the
    in-range day-of-month case (no month-length clamping needed for
    d=1 uses)."""
    yy = y - (m <= 2)
    era = yy // 400
    yoe = yy - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + dom - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _lower_date_part(e: PE.ScalarFunctionExpr, aux):
    """EXTRACT/date_part over Date32/Date64/timestamps (no time zone):
    calendar fields are integer arithmetic on epoch days — fully
    fusable into the surrounding program. Host twin:
    functions/datetime_impl.date_part (reference:
    functions/src/datetime/date_part.rs)."""
    jnp = _jnp()
    from ..functions.datetime_impl import _PART_ALIASES, _TS_SCALE
    lit = e.args[0]
    if not isinstance(lit, PE.LiteralExpr) or lit.value.value is None:
        raise LoweringError("date_part needs a literal part")
    part = _PART_ALIASES.get(str(lit.value.value).lower())
    col = e.args[1]
    ct = col.out_type
    if getattr(ct, "tz", None):
        raise LoweringError("tz-aware date_part stays on host")
    if ct.id == TypeId.DATE:
        to_us = 1000 if ct.unit == "ms" else 86_400_000_000
    elif ct.id == TypeId.TIMESTAMP:
        scale = _TS_SCALE[ct.unit]
        to_us = (10**6 // scale) if scale <= 10**6 else -(scale // 10**6)
    else:
        raise LoweringError("date_part needs a date/timestamp input")
    if part not in ("year", "quarter", "month", "day", "week", "doy",
                    "dow", "epoch", "hour", "minute", "second",
                    "millisecond", "microsecond", "nanosecond"):
        raise LoweringError(f"date_part part '{part}' not lowerable")
    inner = _lower(col, aux)
    out_np = e.out_type.device_dtype()

    def t(cols, valids, a):
        d, v = inner(cols, valids, a)
        us = d.astype(jnp.int64)
        us = us // (-to_us) if to_us < 0 else us * to_us
        days = us // 86_400_000_000
        within = us - days * 86_400_000_000
        if part == "epoch":
            out = us.astype(jnp.float64) / 1e6
            return out.astype(out_np), v
        if part in ("year", "quarter", "month", "day", "doy", "week"):
            y, m, dom = _device_days_to_ymd(jnp, days)
            if part == "year":
                out = y
            elif part == "quarter":
                out = (m - 1) // 3 + 1
            elif part == "month":
                out = m
            elif part == "day":
                out = dom
            elif part == "doy":
                jan1 = _device_ymd_to_days(jnp, y, jnp.ones_like(m),
                                           jnp.ones_like(m))
                out = days - jan1 + 1
            else:  # ISO week: week of this week's Thursday
                dow = (days + 3) % 7
                thu = days - dow + 3
                ty, _, _ = _device_days_to_ymd(jnp, thu)
                jan1 = _device_ymd_to_days(jnp, ty, jnp.ones_like(ty),
                                           jnp.ones_like(ty))
                out = (thu - jan1) // 7 + 1
        elif part == "dow":
            out = (days + 4) % 7
        elif part == "hour":
            out = within // 3_600_000_000
        elif part == "minute":
            out = within % 3_600_000_000 // 60_000_000
        elif part == "second":
            out = within % 60_000_000 // 1_000_000
        elif part == "millisecond":
            out = within % 60_000_000 // 1000
        elif part == "microsecond":
            out = within % 60_000_000
        else:   # nanosecond
            out = within % 60_000_000 * 1000
        return out.astype(out_np), v
    return t
