"""Both parse() functions give equal ASTs over every app text of the
reference corpus (dataclass trees, AttrType compared by name), and the
same error class on apps either rejects."""
import dataclasses
import enum
import json
import pathlib

import pytest
import torch

import siddhi_tpu.lang.parser as jparser
import siddhi_tpu_torch.lang.parser as tparser

torch.set_num_threads(1)

CORPUS = pathlib.Path(__file__).parent / "ref_corpus"


def _apps():
    out = []
    for f in sorted(CORPUS.glob("*.json")):
        for c in json.loads(f.read_text())["cases"]:
            out.append((f"{f.stem}::{c['name']}", c["app"]))
    return out


APPS = _apps()


def same_tree(a, b, path="app"):
    """Structural equality of two AST trees from the two packages."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same_tree(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
    elif isinstance(a, enum.Enum):
        assert isinstance(b, enum.Enum) and a.name == b.name, path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same_tree(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert type(a) is type(b) and (a == b or a != a and b != b), \
            (path, a, b)


def _parse(mod, text):
    try:
        return mod.parse(text), None
    except Exception as e:  # noqa: BLE001 — compared by class name
        return None, type(e).__name__


@pytest.mark.parametrize("chunk", range(8))
def test_corpus_asts_equal(chunk):
    cases = APPS[chunk::8]
    assert cases
    for cid, text in cases:
        ja, jerr = _parse(jparser, text)
        ta, terr = _parse(tparser, text)
        assert jerr == terr, (cid, jerr, terr)
        if ja is not None:
            same_tree(ja, ta, cid)


@pytest.mark.parametrize("text", [
    "define stream S (a int); from S[a > 'x'] select a insert into O;",
    "define stream S (a int); from S[a + 1] select a insert into O;",
    "define stream S (a int); from T select a insert into O;",
    "define stream S (a int); from S select b insert into O;",
    "define stream S (a int); from S select a insert into;",
    "define stream S (a string); from S[a > 'x'] select a insert into O;",
])
def test_rejected_apps_raise_same_error_class(text):
    _, jerr = _parse(jparser, text)
    _, terr = _parse(tparser, text)
    assert jerr is not None and jerr == terr, (jerr, terr)
