"""SiddhiQL tokenizer.

Hand-written lexer producing the same token surface as the reference's ANTLR4
grammar (modules/siddhi-query-compiler/.../SiddhiQL.g4 lexer rules :748-918):
case-insensitive keywords, typed numeric literals (10, 10L, 1.5f, 1.5 / 1.5d,
scientific), quoted strings ('..', "..", triple-quoted), backquoted ids,
`--` line comments, `/* */` block comments, `{...}` script bodies, and the
multi-char operators `->`, `...`, `==`, `!=`, `<=`, `>=`.
"""
from __future__ import annotations

import dataclasses


class SiddhiParserException(Exception):
    pass


@dataclasses.dataclass
class Token:
    kind: str       # 'ID','INT','LONG','FLOAT','DOUBLE','STRING','SCRIPT','OP','KW','EOF'
    value: object   # normalized: lowercase canonical keyword, numeric value, op text
    text: str       # original text
    line: int
    col: int

    def __repr__(self):
        return f"{self.kind}:{self.value!r}@{self.line}:{self.col}"


# canonical keyword -> itself; variants map to canonical
_KEYWORDS = {
    "define", "stream", "table", "window", "trigger", "function", "aggregation",
    "aggregate", "app", "from", "partition", "select", "group", "by", "order",
    "limit", "offset", "asc", "desc", "having", "insert", "delete", "update",
    "set", "return", "events", "into", "output", "expired", "current",
    "snapshot", "for", "raw", "of", "as", "at", "or", "and", "in", "on", "is",
    "not", "within", "with", "begin", "end", "null", "every", "last", "all",
    "first", "join", "inner", "outer", "right", "left", "full",
    "unidirectional", "per", "true", "false", "string", "int", "long",
    "float", "double", "bool", "object",
}

# time-unit keywords -> (canonical, millis multiplier)
TIME_UNITS = {
    "year": ("years", 365 * 24 * 60 * 60 * 1000),
    "years": ("years", 365 * 24 * 60 * 60 * 1000),
    "month": ("months", 30 * 24 * 60 * 60 * 1000),
    "months": ("months", 30 * 24 * 60 * 60 * 1000),
    "week": ("weeks", 7 * 24 * 60 * 60 * 1000),
    "weeks": ("weeks", 7 * 24 * 60 * 60 * 1000),
    "day": ("days", 24 * 60 * 60 * 1000),
    "days": ("days", 24 * 60 * 60 * 1000),
    "hour": ("hours", 60 * 60 * 1000),
    "hours": ("hours", 60 * 60 * 1000),
    "min": ("minutes", 60 * 1000),
    "minute": ("minutes", 60 * 1000),
    "minutes": ("minutes", 60 * 1000),
    "sec": ("seconds", 1000),
    "second": ("seconds", 1000),
    "seconds": ("seconds", 1000),
    "millisec": ("milliseconds", 1),
    "millisecond": ("milliseconds", 1),
    "milliseconds": ("milliseconds", 1),
}

_OPS3 = ("...",)
_OPS2 = ("->", "==", "!=", "<=", ">=")
_OPS1 = "()[],;:.@#!?*+-/%<>=…"


def tokenize(text: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(text)
    line, col = 1, 1

    def adv(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and text[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    def err(msg):
        raise SiddhiParserException(f"{msg} at line {line}:{col}")

    while i < n:
        c = text[i]
        # whitespace
        if c in " \t\r\n\x0b":
            adv(1)
            continue
        # comments
        if text.startswith("--", i):
            while i < n and text[i] != "\n":
                adv(1)
            continue
        if text.startswith("/*", i):
            end = text.find("*/", i + 2)
            adv((end + 2 - i) if end != -1 else (n - i))
            continue
        l0, c0 = line, col
        # script body { ... } (balanced braces; grammar SCRIPT rule)
        if c == "{":
            depth = 0
            j = i
            while j < n:
                if text[j] == "{":
                    depth += 1
                elif text[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                elif text[j] == '"':
                    j += 1
                    while j < n and text[j] != '"':
                        j += 1
                j += 1
            if depth != 0:
                err("unterminated script body")
            body = text[i + 1:j]
            adv(j + 1 - i)
            toks.append(Token("SCRIPT", body, body, l0, c0))
            continue
        # strings
        if text.startswith('"""', i):
            end = text.find('"""', i + 3)
            if end == -1:
                err("unterminated triple-quoted string")
            s = text[i + 3:end]
            adv(end + 3 - i)
            toks.append(Token("STRING", s, s, l0, c0))
            continue
        if c in "'\"":
            j = i + 1
            while j < n and text[j] != c:
                if text[j] == "\n":
                    err("unterminated string")
                j += 1
            if j >= n:
                err("unterminated string")
            s = text[i + 1:j]
            adv(j + 1 - i)
            toks.append(Token("STRING", s, s, l0, c0))
            continue
        # template placeholder `${name}` / `${name:type}` (tenant
        # templates, serving/template.py). Untyped `${name}` normally
        # never reaches the lexer — SiddhiCompiler-style env substitution
        # (parser.update_variables) or the Template's structural binding
        # pass replaces it first — but when it does, the parser builds an
        # untyped TemplateParam and the `template-binding` plan rule
        # rejects it with a proper CompileError.
        if c == "$" and i + 1 < n and text[i + 1] == "{":
            j = text.find("}", i + 2)
            if j == -1:
                err("unterminated template placeholder '${'")
            body = text[i + 2:j]
            raw = text[i:j + 1]
            adv(j + 1 - i)
            toks.append(Token("TPARAM", body, raw, l0, c0))
            continue
        # backquoted id
        if c == "`":
            j = text.find("`", i + 1)
            if j == -1:
                err("unterminated backquoted identifier")
            s = text[i + 1:j]
            adv(j + 1 - i)
            toks.append(Token("ID", s, s, l0, c0))
            continue
        # numbers (also leading-dot decimals like .5)
        if c.isdigit() or (c == "." and i + 1 < n and text[i + 1].isdigit()):
            j = i
            while j < n and text[j].isdigit():
                j += 1
            is_float_form = False
            if j < n and text[j] == "." and not text.startswith("...", j):
                # "1." is a legal DOUBLE_LITERAL (attribute dots never follow
                # a digit: pattern indexes are bracketed, e.g. e1[0].v)
                is_float_form = True
                j += 1
                while j < n and text[j].isdigit():
                    j += 1
            if j < n and text[j] in "eE" and (
                (j + 1 < n and (text[j + 1].isdigit() or
                                (text[j + 1] in "+-" and j + 2 < n and text[j + 2].isdigit())))):
                is_float_form = True
                j += 1
                if text[j] in "+-":
                    j += 1
                while j < n and text[j].isdigit():
                    j += 1
            raw = text[i:j]
            suffix = text[j].lower() if j < n and text[j] in "lLfFdD" else None
            if suffix:
                j += 1
            tok_text = text[i:j]
            adv(j - i)
            if suffix == "l":
                if is_float_form:
                    err("invalid long literal")
                toks.append(Token("LONG", int(raw), tok_text, l0, c0))
            elif suffix == "f":
                toks.append(Token("FLOAT", float(raw), tok_text, l0, c0))
            elif suffix == "d":
                toks.append(Token("DOUBLE", float(raw), tok_text, l0, c0))
            elif is_float_form:
                toks.append(Token("DOUBLE", float(raw), tok_text, l0, c0))
            else:
                toks.append(Token("INT", int(raw), tok_text, l0, c0))
            continue
        # identifiers / keywords
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            word = text[i:j]
            adv(j - i)
            low = word.lower()
            if low in TIME_UNITS:
                toks.append(Token("KW", TIME_UNITS[low][0], word, l0, c0))
            elif low in _KEYWORDS:
                toks.append(Token("KW", low, word, l0, c0))
            else:
                toks.append(Token("ID", word, word, l0, c0))
            continue
        # operators
        matched = False
        for op in _OPS3 + _OPS2:
            if text.startswith(op, i):
                adv(len(op))
                toks.append(Token("OP", op, op, l0, c0))
                matched = True
                break
        if matched:
            continue
        if c in _OPS1:
            adv(1)
            toks.append(Token("OP", "..." if c == "…" else c, c, l0, c0))
            continue
        err(f"unexpected character {c!r}")

    toks.append(Token("EOF", None, "", line, col))
    return toks
