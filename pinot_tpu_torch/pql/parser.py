"""PQL parser: query text -> BrokerRequest.

Implements the language defined by the reference grammar
(pinot-common ``src/main/antlr4/.../PQL2.g4``) with a hand-written
tokenizer + recursive-descent parser (no ANTLR dependency):

    SELECT [TOP n] (* | col|agg(col) [, ...]) FROM table
      [WHERE predicates] [GROUP BY cols] [HAVING pred]
      [ORDER BY col [ASC|DESC], ...] [TOP n] [LIMIT n[, m]]

Predicates: ``=  <>  !=  <  >  <=  >=``, ``BETWEEN a AND b``,
``[NOT] IN (v, ...)``, ``REGEXP_LIKE(col, 'pattern')``, combined with
AND/OR and parentheses.  AND binds tighter than OR (standard SQL; the
reference's Pql2 compiler flattens the same way via its precedence
handling in ``pql/parsers/pql2/ast/PredicateListAstNode.java``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

from pinot_tpu_torch.common.request import (
    AGGREGATION_FUNCTIONS,
    AggregationInfo,
    BrokerRequest,
    FilterOperator,
    FilterQueryTree,
    GroupBy,
    HavingSpec,
    JoinSpec,
    RangeSpec,
    Selection,
    SelectionSort,
)


class PqlParseError(ValueError):
    pass


# keywords that terminate a FROM-clause table/alias position — an ident
# here is a clause, not an alias
_CLAUSE_KEYWORDS = frozenset(
    {"WHERE", "GROUP", "ORDER", "HAVING", "TOP", "LIMIT", "JOIN", "INNER",
     "CROSS", "LEFT", "RIGHT", "FULL", "OUTER", "ON", "AS"}
)


_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+)
    | (?P<comment>--[^\n]*)
    | (?P<number>[-+]?(\d+\.\d*|\.\d+|\d+)([eE][-+]?\d+)?)
    | (?P<string>'(?:[^']|'')*'|"(?:[^"]|"")*")
    | (?P<ident>[A-Za-z_][A-Za-z0-9_\-]*)
    | (?P<op><>|<=|>=|!=|[=<>(),.;*])
    """,
    re.VERBOSE,
)


@dataclass
class Token:
    kind: str  # 'number' | 'string' | 'ident' | 'op' | 'eof'
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


def _tokenize(pql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    n = len(pql)
    while pos < n:
        m = _TOKEN_RE.match(pql, pos)
        if m is None:
            raise PqlParseError(f"unexpected character {pql[pos]!r} at position {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "string":
            quote = text[0]
            text = text[1:-1].replace(quote * 2, quote)
        tokens.append(Token(kind=kind, text=text, pos=m.start()))
    tokens.append(Token(kind="eof", text="", pos=n))
    return tokens


class _Parser:
    def __init__(self, pql: str) -> None:
        self.tokens = _tokenize(pql)
        self.i = 0

    # -- token helpers -------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_kw(self, *kws: str) -> Optional[Token]:
        t = self.peek()
        if t.kind == "ident" and t.upper in kws:
            return self.next()
        return None

    def expect_kw(self, kw: str) -> Token:
        t = self.accept_kw(kw)
        if t is None:
            raise PqlParseError(f"expected {kw} at position {self.peek().pos}, got {self.peek().text!r}")
        return t

    def accept_op(self, *ops: str) -> Optional[Token]:
        t = self.peek()
        if t.kind == "op" and t.text in ops:
            return self.next()
        return None

    def expect_op(self, op: str) -> Token:
        t = self.accept_op(op)
        if t is None:
            raise PqlParseError(f"expected {op!r} at position {self.peek().pos}, got {self.peek().text!r}")
        return t

    def expect_ident(self) -> Token:
        t = self.peek()
        if t.kind != "ident":
            raise PqlParseError(f"expected identifier at position {t.pos}, got {t.text!r}")
        return self.next()

    # -- grammar -------------------------------------------------------
    def parse(self) -> BrokerRequest:
        # EXPLAIN [ANALYZE] [PLAN FOR] SELECT ... — the introspection
        # prefix (reference later grew ``EXPLAIN PLAN FOR``, see
        # PARITY.md).  EXPLAIN returns the physical plan without
        # executing; EXPLAIN ANALYZE executes and annotates the plan
        # nodes with actuals from the cost vector.
        explain: Optional[str] = None
        if self.accept_kw("EXPLAIN"):
            explain = "analyze" if self.accept_kw("ANALYZE") else "plan"
            if self.accept_kw("PLAN"):
                self.expect_kw("FOR")
        self.expect_kw("SELECT")
        top_n: Optional[int] = None
        if self.accept_kw("TOP"):
            top_n = self._int_literal()

        star, projections = self._output_columns()
        self.expect_kw("FROM")
        table = self._table_name()
        left_alias = self._maybe_alias()
        join = None
        join_aliases: Optional[dict] = None
        if self.peek().kind == "op" and self.peek().text == ",":
            # comma-separated FROM lists are implicit cross joins
            raise PqlParseError(
                "cross joins are not supported: use JOIN ... ON <a.col> = <b.col>"
            )
        if self.accept_kw("CROSS"):
            raise PqlParseError(
                "cross joins are not supported: use JOIN ... ON <a.col> = <b.col>"
            )
        if self.accept_kw("LEFT", "RIGHT", "FULL", "OUTER"):
            raise PqlParseError(
                "only INNER equi-joins are supported (LEFT/RIGHT/FULL/OUTER "
                "joins are not)"
            )
        inner = self.accept_kw("INNER")
        if self.accept_kw("JOIN"):
            join, join_aliases = self._join_clause(table, left_alias)
        elif inner is not None:
            raise PqlParseError("expected JOIN after INNER")

        filter_tree: Optional[FilterQueryTree] = None
        group_by_cols: List[str] = []
        having: Optional[HavingSpec] = None
        sorts: List[SelectionSort] = []
        offset, size = 0, None

        while True:
            if self.accept_kw("WHERE"):
                filter_tree = self._predicate_list()
            elif self.peek().upper == "GROUP":
                self.next()
                self.expect_kw("BY")
                group_by_cols = [self._column_token()]
                while self.accept_op(","):
                    group_by_cols.append(self._column_token())
            elif self.accept_kw("HAVING"):
                having = self._having()
            elif self.peek().upper == "ORDER":
                self.next()
                self.expect_kw("BY")
                sorts = [self._order_by_expr()]
                while self.accept_op(","):
                    sorts.append(self._order_by_expr())
            elif self.accept_kw("TOP"):
                top_n = self._int_literal()
            elif self.accept_kw("LIMIT"):
                a = self._int_literal()
                if self.accept_op(","):
                    # LIMIT offset, size (PQL2.g4 limitClause)
                    offset, size = a, self._int_literal()
                else:
                    size = a
            elif self.accept_op(";"):
                continue
            elif self.peek().kind == "eof":
                break
            else:
                raise PqlParseError(
                    f"unexpected token {self.peek().text!r} at position {self.peek().pos}"
                )

        # Assemble the request.
        aggregations = [p for p in projections if isinstance(p, AggregationInfo)]
        plain_cols = [p for p in projections if isinstance(p, str)]
        if aggregations and plain_cols:
            raise PqlParseError("cannot mix aggregation functions and plain columns in SELECT")

        req = BrokerRequest(table_name=table)
        req.explain = explain
        req.filter = filter_tree
        req.having = having
        req.join = join
        if aggregations:
            req.aggregations = aggregations
            if group_by_cols:
                req.group_by = GroupBy(columns=group_by_cols, top_n=top_n if top_n is not None else 10)
        else:
            if star and join is not None:
                raise PqlParseError(
                    "SELECT * is not supported in join queries: name the "
                    "output columns explicitly (qualified with a side alias)"
                )
            sel_cols = ["*"] if star else plain_cols
            req.selection = Selection(
                columns=sel_cols,
                sorts=sorts,
                offset=offset,
                size=size if size is not None else 10,
            )
        if join is not None:
            _resolve_join_columns(req, join, join_aliases)
        else:
            _reject_qualified_columns(req)
        return req

    def _maybe_alias(self) -> Optional[str]:
        """``[AS] alias`` after a FROM-clause table name, or None."""
        if self.accept_kw("AS"):
            return self.expect_ident().text
        t = self.peek()
        if t.kind == "ident" and t.upper not in _CLAUSE_KEYWORDS:
            return self.next().text
        return None

    def _join_clause(self, left_table: str, left_alias: Optional[str]):
        """``JOIN <table> [AS alias] ON <x.k> = <y.k>`` — returns the
        JoinSpec plus the alias->side map used by column resolution.
        Everything outside a single INNER equi-join between exactly two
        tables is a typed parse error (clear 4xx, never a crash)."""
        right_table = self._table_name()
        right_alias = self._maybe_alias()
        self.expect_kw("ON")
        lref = self._qualified_ref("ON")
        op = self.accept_op("=")
        if op is None:
            bad = self.peek()
            raise PqlParseError(
                "only equi-joins are supported: the ON predicate must be "
                f"<a.col> = <b.col> (got {bad.text!r} at position {bad.pos})"
            )
        rref = self._qualified_ref("ON")
        if self.peek().kind == "ident" and self.peek().upper in ("AND", "OR"):
            raise PqlParseError(
                "compound ON predicates are not supported: exactly one "
                "equality between one column from each side"
            )
        if self.peek().kind == "ident" and self.peek().upper == "JOIN" or (
            self.peek().upper in ("INNER", "CROSS") and self.peek(1).upper == "JOIN"
        ):
            raise PqlParseError("at most two tables can be joined (one JOIN clause)")
        aliases: dict = {}
        for name, side in (
            (left_table, "l"), (left_alias, "l"),
            (right_table, "r"), (right_alias, "r"),
        ):
            if not name:
                continue
            if aliases.get(name, side) != side:
                raise PqlParseError(
                    f"alias {name!r} is ambiguous: it names both join sides"
                )
            aliases[name] = side
        sides = {}
        for qual, col in (lref, rref):
            side = aliases.get(qual)
            if side is None:
                raise PqlParseError(
                    f"unknown table alias {qual!r} in ON clause"
                )
            if side in sides:
                raise PqlParseError(
                    "the ON equality must reference one column from EACH "
                    f"side (both operands resolve to the same table)"
                )
            sides[side] = col
        # reversed ON order (b.k = a.k) normalizes here: sides are
        # keyed by resolution, not operand position
        spec = JoinSpec(
            right_table=right_table,
            left_key=sides["l"],
            right_key=sides["r"],
        )
        return spec, aliases

    def _qualified_ref(self, where: str) -> Tuple[str, str]:
        """``alias.col`` (both idents required) for the ON clause."""
        t = self.expect_ident()
        if not self.accept_op("."):
            raise PqlParseError(
                f"column references in {where} must be qualified as "
                f"<alias>.<column> (got bare {t.text!r} at position {t.pos})"
            )
        return t.text, self.expect_ident().text

    def _output_columns(self) -> Tuple[bool, List[object]]:
        if self.accept_op("*"):
            return True, []
        projections: List[object] = [self._output_column()]
        while self.accept_op(","):
            projections.append(self._output_column())
        return False, projections

    def _column_token(self) -> str:
        """A column reference: ``col`` or ``alias.col`` (the dotted form
        is resolved to a join side after the FROM clause is known)."""
        t = self.expect_ident()
        if self.accept_op("."):
            return t.text + "." + self.expect_ident().text
        return t.text

    def _output_column(self) -> object:
        t = self.expect_ident()
        if self.peek().kind == "op" and self.peek().text == "(":
            # aggregation function call
            func = t.text.lower()
            self.expect_op("(")
            if self.accept_op("*"):
                col = "*"
            else:
                col = self._column_token()
            self.expect_op(")")
            if self.accept_kw("AS"):
                self.next()  # alias ignored (reference keeps function_col naming)
            if func not in AGGREGATION_FUNCTIONS:
                raise PqlParseError(f"unknown aggregation function {func!r}")
            return AggregationInfo(function=func, column=col)
        name = t.text
        if self.accept_op("."):
            name += "." + self.expect_ident().text
        if self.accept_kw("AS"):
            self.next()
        return name

    def _table_name(self) -> str:
        t = self.peek()
        if t.kind == "string":
            return self.next().text
        name = self.expect_ident().text
        if self.accept_op("."):
            name += "." + self.expect_ident().text
        return name

    def _int_literal(self) -> int:
        t = self.next()
        if t.kind != "number":
            raise PqlParseError(f"expected integer at position {t.pos}, got {t.text!r}")
        return int(float(t.text))

    def _literal(self) -> str:
        t = self.next()
        if t.kind not in ("number", "string", "ident"):
            raise PqlParseError(f"expected literal at position {t.pos}, got {t.text!r}")
        return t.text

    # predicates: OR( AND( unit ) ) with parens
    def _predicate_list(self) -> FilterQueryTree:
        node = self._and_list()
        children = [node]
        while self.accept_kw("OR"):
            children.append(self._and_list())
        if len(children) == 1:
            return children[0]
        return FilterQueryTree(operator=FilterOperator.OR, children=children)

    def _and_list(self) -> FilterQueryTree:
        node = self._predicate_unit()
        children = [node]
        while self.accept_kw("AND"):
            children.append(self._predicate_unit())
        if len(children) == 1:
            return children[0]
        return FilterQueryTree(operator=FilterOperator.AND, children=children)

    def _predicate_unit(self) -> FilterQueryTree:
        if self.accept_op("("):
            node = self._predicate_list()
            self.expect_op(")")
            return node

        t = self.expect_ident()
        if t.upper == "REGEXP_LIKE" and self.peek().text == "(":
            self.expect_op("(")
            col = self._column_token()
            self.expect_op(",")
            pattern = self._literal()
            self.expect_op(")")
            return FilterQueryTree(operator=FilterOperator.REGEX, column=col, values=[pattern])

        column = t.text
        if self.accept_op("."):
            column += "." + self.expect_ident().text
        if self.accept_kw("BETWEEN"):
            lo = self._literal()
            self.expect_kw("AND")
            hi = self._literal()
            return FilterQueryTree(
                operator=FilterOperator.RANGE,
                column=column,
                range_spec=RangeSpec(lower=lo, upper=hi, include_lower=True, include_upper=True),
            )
        if self.accept_kw("NOT"):
            self.expect_kw("IN")
            vals = self._in_list()
            return FilterQueryTree(operator=FilterOperator.NOT_IN, column=column, values=vals)
        if self.accept_kw("IN"):
            vals = self._in_list()
            return FilterQueryTree(operator=FilterOperator.IN, column=column, values=vals)

        op = self.accept_op("=", "<>", "!=", "<", ">", "<=", ">=")
        if op is None:
            raise PqlParseError(f"expected predicate operator at position {self.peek().pos}")
        value = self._literal()
        if op.text == "=":
            return FilterQueryTree(operator=FilterOperator.EQUALITY, column=column, values=[value])
        if op.text in ("<>", "!="):
            return FilterQueryTree(operator=FilterOperator.NOT, column=column, values=[value])
        spec = {
            "<": RangeSpec(upper=value, include_upper=False),
            "<=": RangeSpec(upper=value, include_upper=True),
            ">": RangeSpec(lower=value, include_lower=False),
            ">=": RangeSpec(lower=value, include_lower=True),
        }[op.text]
        return FilterQueryTree(operator=FilterOperator.RANGE, column=column, range_spec=spec)

    def _in_list(self) -> List[str]:
        self.expect_op("(")
        vals = [self._literal()]
        while self.accept_op(","):
            vals.append(self._literal())
        self.expect_op(")")
        return vals

    def _having(self) -> HavingSpec:
        func_tok = self.expect_ident()
        self.expect_op("(")
        if self.accept_op("*"):
            col = "*"
        else:
            col = self._column_token()
        self.expect_op(")")
        op = self.accept_op("=", "<>", "!=", "<", ">", "<=", ">=")
        if op is None:
            raise PqlParseError(f"expected comparison in HAVING at position {self.peek().pos}")
        val = float(self._literal())
        return HavingSpec(function=func_tok.text.lower(), column=col, operator=op.text, value=val)

    def _order_by_expr(self) -> SelectionSort:
        col = self._column_token()
        asc = True
        if self.accept_kw("DESC"):
            asc = False
        elif self.accept_kw("ASC"):
            asc = True
        return SelectionSort(column=col, ascending=asc)


def _rewrite_request_columns(req: BrokerRequest, fn) -> None:
    """Apply ``fn(name) -> name`` to every column reference in the
    request (filter leaves, aggregation inputs, group-by, selection,
    sorts, having).  ``"*"`` passes through untouched."""

    def f(name: Optional[str]) -> Optional[str]:
        if name is None or name == "*":
            return name
        return fn(name)

    if req.filter is not None:
        for node in req.filter.walk():
            if node.is_leaf:
                node.column = f(node.column)
    for a in req.aggregations:
        a.column = f(a.column)
    if req.group_by is not None:
        req.group_by.columns = [f(c) for c in req.group_by.columns]
    if req.selection is not None:
        req.selection.columns = [f(c) for c in req.selection.columns]
        for s in req.selection.sorts:
            s.column = f(s.column)
    if req.having is not None:
        req.having.column = f(req.having.column)


def _resolve_join_columns(req: BrokerRequest, join: JoinSpec, aliases: dict) -> None:
    """Resolve every ``alias.col`` reference to its join side: left-side
    columns become bare names, right-side columns the canonical
    ``"<right_table>.<col>"`` form (stable across alias spellings, so
    two phrasings of one semantic query share a plan-shape digest).
    Bare references in a join query are rejected — requiring
    qualification makes side resolution purely syntactic instead of
    depending on schemas the broker may not hold."""

    def resolve(name: str) -> str:
        if "." not in name:
            raise PqlParseError(
                "column references in a join query must be qualified with "
                f"a table alias (got bare {name!r})"
            )
        qual, col = name.split(".", 1)
        side = aliases.get(qual)
        if side is None:
            raise PqlParseError(f"unknown table alias {qual!r}")
        return col if side == "l" else join.right_prefix() + col

    _rewrite_request_columns(req, resolve)


def _reject_qualified_columns(req: BrokerRequest) -> None:
    """Single-table queries have no aliases to resolve against: a
    dotted reference is a typed client error, not a silent column name
    with a dot in it."""

    def check(name: str) -> str:
        if "." in name:
            raise PqlParseError(
                f"qualified column reference {name!r} is only valid in a "
                "join query"
            )
        return name

    _rewrite_request_columns(req, check)


def parse_pql(pql: str) -> BrokerRequest:
    """Parse a PQL query string into a BrokerRequest."""
    return _Parser(pql).parse()
