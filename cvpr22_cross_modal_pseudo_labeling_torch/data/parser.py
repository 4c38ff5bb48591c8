"""Caption -> LVIS noun-phrase parser.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
parser.py``; it reads the port's own copy of the LVIS v1 category
resource.

Re-design of reference data/datasets/helper/parser.py:23-74
(LVISParser): build a lemmatized synonym lookup over the 1203 LVIS v1
categories, lemmatize the caption, and substring-match synonyms.

spaCy is unavailable in this environment, so lemmatization uses a
self-contained rule-based English lemmatizer (inflection suffix rules +
an irregular table) — equivalent for the noun vocabulary this lookup
targets; the lookup keys are built with the same lemmatizer so matching
stays internally consistent.  Category ids returned are 0-based
(``item['id'] - 1``), matching the reference's convention
(parser.py:33, st_generalized_rcnn.py:72-74).
"""

import gzip
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

_RESOURCE = os.path.join(
    os.path.dirname(__file__), "resources", "lvis_v1_categories.json.gz"
)

_IRREGULAR = {
    "men": "man", "women": "woman", "children": "child", "teeth": "tooth",
    "feet": "foot", "geese": "goose", "mice": "mouse", "people": "person",
    "knives": "knife", "leaves": "leaf", "loaves": "loaf", "wolves": "wolf",
    "shelves": "shelf", "scarves": "scarf", "calves": "calf",
    "wives": "wife", "lives": "life", "halves": "half", "oxen": "ox",
    "dice": "die", "geese": "goose", "cacti": "cactus",
}

_KEEP_S = {
    "glasses", "scissors", "pants", "shorts", "jeans", "pliers", "tongs",
    "trousers", "binoculars", "overalls", "pajamas", "tweezers", "chess",
    "asparagus", "bus", "gas", "lens", "octopus", "hummus", "grits",
    "molasses", "press", "dress", "chaps",
}


def lemmatize_word(w: str) -> str:
    """Singularizes a (lowercased) English noun with simple rules."""
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if w in _KEEP_S or len(w) <= 3:
        return w
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith(("ches", "shes", "xes", "sses", "zes")):
        return w[:-2]
    if w.endswith("oes") and len(w) > 4:
        return w[:-2]
    if w.endswith("s") and not w.endswith(("ss", "us", "is")):
        return w[:-1]
    return w


def lemmatize_phrase(phrase: str) -> str:
    toks = re.findall(r"[a-z0-9]+(?:-[a-z0-9]+)*|\S", phrase.lower())
    return " ".join(lemmatize_word(t) for t in toks)


def normalize_class_names(names: Sequence[str]) -> List[str]:
    """normalize_class_names (parser.py:10-21): strip separators,
    lowercase."""
    out = []
    for name in names:
        n = name.replace("_", " ").replace("/", " ")
        n = n.replace("(", " ").replace(")", " ")
        out.append(" ".join(n.lower().split()))
    return out


def load_lvis_categories() -> List[dict]:
    with gzip.open(_RESOURCE, "rt") as f:
        return json.load(f)


class LVISParser:
    """Synonym-lookup caption parser (parser.py:23-74)."""

    def __init__(self):
        cats = load_lvis_categories()
        self.class_names = [""] * len(cats)
        self.look_up: Dict[str, int] = {}
        for item in cats:
            idx = item["id"] - 1  # 0-based, like the reference
            self.class_names[idx] = item["name"]
            for syn in item["synonyms"]:
                s = syn.lower().replace("_", " ")
                # drop parenthesised qualifiers, like the reference's
                # token loop break on '(' (parser.py:41-44)
                s = s.split("(")[0].strip()
                if not s:
                    continue
                key = lemmatize_phrase(s).replace(" - ", "-")
                self.look_up[key] = idx
        # word inventory of the keys, for the gerund fallback below
        self._key_words = set()
        for key in self.look_up:
            self._key_words.update(key.replace("-", " ").split())

    # -ing words that are noun-dominant in caption usage: spaCy (the
    # reference lemmatizer) lemmatizes nouns to themselves, so stemming
    # these would mint category ids the reference never emits ("salad
    # dressing" -> dress, "bedding" -> bed).  Ambiguous verbal/noun
    # words ("setting", "bearing", "batting") deliberately stay
    # stemmable: their verbal caption uses ("sun setting") lemmatize to
    # the stem in the reference too, and the reference's match is
    # equally sense-blind.
    _NOUN_ING = frozenset(
        "bedding booking canning caring clothing decking dressing "
        "housing icing matting mugging padding paneling panelling "
        "railing topping".split()
    )

    def _degerund(self, tok: str) -> str:
        """spaCy lemmatizes gerunds in verbal position to the verb stem
        ("skiing" -> "ski"), which the reference relies on to catch
        activity captions naming LVIS objects ("a man skiing" -> ski).
        Context-free approximation: map an -ing token to its stem only
        when the stem is a known key word, the token itself is not
        (so noun gerunds that ARE categories, e.g. "painting", stay),
        and the token is not a noun-dominant -ing word (_NOUN_ING)."""
        if (
            not tok.endswith("ing")
            or len(tok) <= 4
            or tok in self._key_words
            or tok in self._NOUN_ING
        ):
            return tok
        bare = tok[:-3]
        cands = [bare]
        if len(tok) > 5 and tok[-4] == tok[-5]:
            cands.append(tok[:-4])  # drumming -> drum
        cands.append(bare + "e")  # saute-type stems
        if (
            len(bare) >= 3
            and bare[-1] not in "aeiouwxy"
            and bare[-2] in "aeiou"
            and bare[-3] not in "aeiou"
        ):
            # single final consonant after a short vowel: the bare stem
            # would have doubled its consonant before -ing ("tubbing"),
            # so the e-stem is the right reading ("tubing" -> tube, not
            # tub; "biking" -> bike)
            cands = [bare + "e", bare]
        for c in cands:
            if c in self._key_words:
                return c
        return tok

    def parse(self, sentence: str) -> Tuple[List[str], List[int]]:
        """Returns (noun phrases, 0-based LVIS category ids)."""
        lemma = " ".join(
            self._degerund(t) for t in lemmatize_phrase(sentence).split()
        )
        padded = f" {lemma} "
        nns, ids = [], []
        for key, idx in self.look_up.items():
            if f" {key} " in padded:
                nns.append(key)
                ids.append(idx)
        return nns, ids


_parser = None


def get_parser() -> LVISParser:
    global _parser
    if _parser is None:
        _parser = LVISParser()
    return _parser


def lvis_ids_for_class_names(names: Sequence[str]) -> List[int]:
    """0-based LVIS category id per dataset class name, -1 when the name
    isn't in the LVIS vocabulary (incl. the background row).

    This is the device-table key for mixing exemplar embeddings into the
    DETECTION branch's class embeddings: the reference's combine_embs
    matches exemplars by noun string against the dataset vocabulary
    (st_generalized_rcnn.py:164-177, used at :372-376)."""
    p = get_parser()
    out = []
    for name in normalize_class_names(names):
        key = lemmatize_phrase(name).replace(" - ", "-")
        out.append(p.look_up.get(key, -1))
    return out
