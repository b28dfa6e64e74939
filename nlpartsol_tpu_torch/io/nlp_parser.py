"""Parser for the reference's `.nlp` Grams/NLPS simulation DSL.

Counterpart of ``nlpartsol_tpu/io/nlp_parser.py`` (numpy only; the port
keeps its own copy because importing the JAX package imports JAX).

Reference grammar (hand-rolled strtok scanners across src/InOutFun/, SURVEY.md
§5.6): brace-delimited keyword blocks with parenthesised attributes,

    Keyword (attr=value, attr2=value) {
        Property=value
        Statement tok1 tok2
        NestedKeyword (…) { … }
    }

Recognised blocks (old Grams* and newer Define-* spellings):
  NLPS-Solver (Type=…) { CFL=…, Cel=…, N=…, … }       (Read_GramsTime.c:96-175)
  GramsTime   — alias of NLPS-Solver
  GramsBox (Type=GID, File=m.msh) { GramsBoundary … }  (Read_GramsBox.c:235-266)
  GramsBoundary (File=nodes.txt) { BcDirichlet V.x curve.txt | NULL }
                                        (NLPS-Read-u-Dirichlet-…c:51-55)
  One-Phase-Analysis (File=p.msh, GPxElement=n) {}     (Generate-One-Phase-Analysis.c)
  GramsSolid — alias of One-Phase-Analysis
  Define-Material (idx=i, Model=…) { E=… nu=… rho=… }  (Read_GramsMaterials2.c:54-66)
  GramsMaterials — alias
  GramsShapeFun (Type=LME) { gamma=… TOL-Zero=… }      (Read_GramsShapeFun.c:84-190)
  Define-Neumann-Boundary / GramsNeumannBC (File=parts.txt) { BcNeumann T.x curve }
  generate-gravity-field-constant { g.x=… g.y=… }      (Read_Generate_Gravity_Field.c)
  GramsBodyForces — alias (curve form)
  GramsOutputs (i=n) { DIR=outdir }
  GramsInitials (File=parts.txt) { VALUE V.x=… }

Returns a list of Block trees; ``io.builder`` turns them into framework
objects.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..utils import curves


@dataclass
class Block:
    keyword: str
    attrs: dict = field(default_factory=dict)
    props: dict = field(default_factory=dict)  # Property=value lines
    statements: list = field(default_factory=list)  # token-list lines
    children: List["Block"] = field(default_factory=list)

    def child(self, keyword) -> Optional["Block"]:
        for c in self.children:
            if c.keyword == keyword:
                return c
        return None

    def all(self, keyword) -> List["Block"]:
        return [c for c in self.children if c.keyword == keyword]


_ATTR_RE = re.compile(r"(?P<kw>[\w\-\.]+)\s*\((?P<attrs>[^)]*)\)\s*(?P<brace>\{?)")


def _split_attrs(s: str):
    """Split on ','/';' only at brace/bracket nesting depth 0, so vector
    literals like ``Value={0;10}`` stay one attribute."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "{[(":
            depth += 1
        elif ch in "}])":
            depth -= 1
        if ch in ",;" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def _parse_attrs(s: str) -> dict:
    out = {}
    # the reference DSL mixes ',' and ';' separators (GramsBox uses commas,
    # Out-*-path-csv intervals use semicolons, NLPS-Out-particle-path-csv.c:65)
    for part in _split_attrs(s):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            out[k.strip()] = v.strip()
        else:
            out[part] = True
    return out


def _coerce(v: str):
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def parse_nlp_text(text: str) -> List[Block]:
    """Parse .nlp source into a Block forest."""
    root = Block(keyword="__root__")
    stack = [root]
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        line = raw.split("!")[0].strip()  # '!' comments (GDF convention)
        if not line or line.startswith(("#", "//")):
            continue
        if line == "}":
            if len(stack) > 1:
                stack.pop()
            continue
        m = _ATTR_RE.match(line)
        if m:
            blk = Block(keyword=m.group("kw"), attrs={
                k: _coerce(v) if isinstance(v, str) else v
                for k, v in _parse_attrs(m.group("attrs")).items()
            })
            stack[-1].children.append(blk)
            rest = line[m.end():].strip()
            opened = m.group("brace") == "{" or rest.startswith("{")
            # lookahead: brace on its own next line
            if not opened and i < len(lines) and lines[i].strip().startswith("{"):
                opened = True
                i += 1
            if opened:
                stack.append(blk)
            continue
        # bare 'Keyword {' (or 'Keyword' with '{' on the next line)
        toks = line.replace("{", " { ").split()
        if len(toks) >= 1 and toks[-1] == "{":
            blk = Block(keyword=toks[0])
            stack[-1].children.append(blk)
            stack.append(blk)
            continue
        if (
            len(toks) == 1
            and "=" not in line
            and i < len(lines)
            and lines[i].strip().startswith("{")
        ):
            blk = Block(keyword=toks[0])
            stack[-1].children.append(blk)
            stack.append(blk)
            i += 1
            continue
        # Property=value
        if "=" in line and len(line.split("=")) == 2 and " " not in line.split("=")[0].strip():
            k, v = line.split("=", 1)
            stack[-1].props[k.strip()] = _coerce(v.strip())
            continue
        # statement line (e.g. 'BcDirichlet V.x curve.txt')
        stack[-1].statements.append(line.split())
    return root.children


def parse_nlp(path: str) -> List[Block]:
    with open(path) as fh:
        return parse_nlp_text(fh.read())


def find(blocks: List[Block], *keywords) -> Optional[Block]:
    for b in blocks:
        if b.keyword in keywords:
            return b
    return None


def find_all(blocks: List[Block], *keywords) -> List[Block]:
    return [b for b in blocks if b.keyword in keywords]


def read_node_list(path: str) -> np.ndarray:
    """Node/particle id list file.  The reference reads these ids VERBATIM
    as 0-based array indices (File2Chain.c:27 pushes atoi(word) straight
    into the set that indexes Nodes2Mask etc.) — unlike the GiD mesh
    connectivity, which is 1-based and decremented on read
    (Read-GID-Mesh.c:407).  Round 3 fix: the previous -1 shifted every
    boundary/path node by one relative to a real reference input deck."""
    ids = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ids.extend(int(t) for t in line.split())
    return np.asarray(ids, np.int64)


def parse_vector(s) -> np.ndarray:
    """Parse the reference's vector literals: '{0 ; 10}' (Read_Vector,
    NLPS-Read-Tools.c) or '[5.0,0.0,0.0]' (Initial-nodal-values)."""
    t = str(s).strip().strip("{}[]()")
    for sep in (";", ","):
        t = t.replace(sep, " ")
    vals = [float(v) for v in t.split()]
    return np.asarray(vals, np.float64)


def read_curve_file(path: str, n_steps: int) -> np.ndarray:
    with open(path) as fh:
        return curves.parse_curve_lines(fh.readlines(), n_steps)
