"""Raw-text normalization: digits, ordinals, currency, dates, abbreviations
(counterpart of ``speechflow_tpu/data/processors/text_norm.py``, copied rule
for rule: the port keeps its own copy so that it imports nothing of the JAX
package).

It runs in front of every raw-text phonemization path (``TextParserHook`` and
subclasses), so ``synthesize("On June 3rd, 1998 ...")`` sees only spellable
words by the time G2P runs.

Scope:

- EN: cardinals to 10^15 (incl. negatives, thousands separators, decimals),
  ordinals (1st/2nd/3rd/11th/22nd), years (1066 -> "ten sixty six",
  2005 -> "two thousand five", 1900 -> "nineteen hundred"), currency
  ($/£/€ with cents), percent, clock times (3:30, 12:00), common titles and
  abbreviations (Mr./Dr./St./etc.) with the street/saint heuristic.
- RU: cardinals to 10^12 with correct gender/number agreement of units and
  the thousand/million scale words, percent, rubles, common abbreviations.

Left as words for G2P: slash dates (3/4/98), roman numerals, phone numbers,
units ("km").
"""

from __future__ import annotations

import re
import typing as tp

__all__ = ["normalize_text", "en_number_to_words", "ru_number_to_words"]


# --------------------------------------------------------------------------- #
#  English numbers                                                             #
# --------------------------------------------------------------------------- #

_EN_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
            "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
            "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]
_EN_SCALE = [(10 ** 15, "quadrillion"), (10 ** 12, "trillion"),
             (10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]
_EN_ORD_IRREG = {"one": "first", "two": "second", "three": "third",
                 "five": "fifth", "eight": "eighth", "nine": "ninth",
                 "twelve": "twelfth"}


def _en_below_thousand(n: int) -> str:
    parts: tp.List[str] = []
    if n >= 100:
        parts += [_EN_ONES[n // 100], "hundred"]
        n %= 100
    if n >= 20:
        t = _EN_TENS[n // 10]
        parts.append(t + (" " + _EN_ONES[n % 10] if n % 10 else ""))
    elif n > 0:
        parts.append(_EN_ONES[n])
    return " ".join(parts)


def en_number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + en_number_to_words(-n)
    if n < 20:
        return _EN_ONES[n]
    parts: tp.List[str] = []
    for base, name in _EN_SCALE:
        if n >= base:
            parts.append(_en_below_thousand(n // base) + " " + name)
            n %= base
    if n:
        parts.append(_en_below_thousand(n))
    return " ".join(parts)


def _en_ordinal_words(n: int) -> str:
    words = en_number_to_words(n).split()
    last = words[-1]
    if "-" in last:
        pass
    if last in _EN_ORD_IRREG:
        words[-1] = _EN_ORD_IRREG[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def _en_year_words(n: int) -> str:
    """Read a year the spoken way: 1998 -> nineteen ninety eight."""
    if 1000 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return en_number_to_words(hi) + " hundred"
        if hi % 10 == 0 and lo < 10:  # 2005 -> two thousand five
            return en_number_to_words(n)
        return en_number_to_words(hi) + " " + (
            "oh " + _EN_ONES[lo] if lo < 10 else en_number_to_words(lo))
    return en_number_to_words(n)


def _en_digits(s: str) -> str:
    """Digit-by-digit reading (long id-like numbers)."""
    return " ".join(_EN_ONES[int(c)] for c in s)


# --------------------------------------------------------------------------- #
#  Russian numbers                                                             #
# --------------------------------------------------------------------------- #

_RU_ONES_M = ["ноль", "один", "два", "три", "четыре", "пять", "шесть", "семь",
              "восемь", "девять", "десять", "одиннадцать", "двенадцать",
              "тринадцать", "четырнадцать", "пятнадцать", "шестнадцать",
              "семнадцать", "восемнадцать", "девятнадцать"]
_RU_TENS = ["", "", "двадцать", "тридцать", "сорок", "пятьдесят", "шестьдесят",
            "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDS = ["", "сто", "двести", "триста", "четыреста", "пятьсот", "шестьсот",
             "семьсот", "восемьсот", "девятьсот"]
# scale word + plural forms (1, 2-4, 5-0): тысяча is feminine
_RU_SCALE = [
    (10 ** 12, ("триллион", "триллиона", "триллионов"), False),
    (10 ** 9, ("миллиард", "миллиарда", "миллиардов"), False),
    (10 ** 6, ("миллион", "миллиона", "миллионов"), False),
    (10 ** 3, ("тысяча", "тысячи", "тысяч"), True),
]


def _ru_plural(n: int, forms: tp.Tuple[str, str, str]) -> str:
    if n % 100 in (11, 12, 13, 14):
        return forms[2]
    if n % 10 == 1:
        return forms[0]
    if n % 10 in (2, 3, 4):
        return forms[1]
    return forms[2]


def _ru_below_thousand(n: int, feminine: bool = False) -> str:
    parts: tp.List[str] = []
    if n >= 100:
        parts.append(_RU_HUNDS[n // 100])
        n %= 100
    if n >= 20:
        parts.append(_RU_TENS[n // 10])
        n %= 10
    if n:
        w = _RU_ONES_M[n]
        if feminine and n == 1:
            w = "одна"
        elif feminine and n == 2:
            w = "две"
        parts.append(w)
    return " ".join(parts)


def ru_number_to_words(n: int) -> str:
    if n < 0:
        return "минус " + ru_number_to_words(-n)
    if n == 0:
        return _RU_ONES_M[0]
    parts: tp.List[str] = []
    for base, forms, fem in _RU_SCALE:
        if n >= base:
            k = n // base
            parts.append(_ru_below_thousand(k, feminine=fem))
            parts.append(_ru_plural(k, forms))
            n %= base
    if n:
        parts.append(_ru_below_thousand(n))
    return " ".join(p for p in parts if p)


# --------------------------------------------------------------------------- #
#  Abbreviations                                                               #
# --------------------------------------------------------------------------- #

_EN_ABBREV = {
    "mr": "mister", "mrs": "missus", "ms": "miss", "dr": "doctor",
    "prof": "professor", "capt": "captain", "gen": "general", "col": "colonel",
    "sgt": "sergeant", "lt": "lieutenant", "rev": "reverend", "hon": "honorable",
    "jr": "junior", "sr": "senior", "vs": "versus", "etc": "et cetera",
    "approx": "approximately", "dept": "department", "est": "established",
    "ave": "avenue", "blvd": "boulevard", "rd": "road", "ln": "lane",
    "ft": "fort", "mt": "mount", "no": "number",
    "jan": "january", "feb": "february", "mar": "march", "apr": "april",
    "jun": "june", "jul": "july", "aug": "august", "sep": "september",
    "sept": "september", "oct": "october", "nov": "november", "dec": "december",
}
# only expanded when written with a trailing period ("no." is ambiguous bare)
_EN_DOT_ONLY = {"no", "st", "rd", "ln", "ft", "mt", "est", "mar", "aug", "dec"}

_EN_MULTI = [
    (re.compile(r"\be\.g\.", re.IGNORECASE), "for example"),
    (re.compile(r"\bi\.e\.", re.IGNORECASE), "that is"),
    (re.compile(r"\ba\.m\.", re.IGNORECASE), "A M"),
    (re.compile(r"\bp\.m\.", re.IGNORECASE), "P M"),
    (re.compile(r"\bU\.S\.A\.?"), "U S A"),
    (re.compile(r"\bU\.S\."), "U S"),
    (re.compile(r"\bU\.K\."), "U K"),
]

_RU_MULTI = [
    (re.compile(r"\bи т\.\s?д\."), "и так далее"),
    (re.compile(r"\bи т\.\s?п\."), "и тому подобное"),
    (re.compile(r"\bт\.\s?е\."), "то есть"),
    (re.compile(r"\bт\.\s?к\."), "так как"),
    (re.compile(r"\bруб\."), "рублей"),
    (re.compile(r"\bкоп\."), "копеек"),
    (re.compile(r"\bг\.(?=\s*\d)"), "год"),      # "г. 1998" rare; usually after
    (re.compile(r"(?<=\d\s)г\."), "года"),       # "1998 г." -> "1998 года"
    (re.compile(r"\bдр\."), "другие"),
    (re.compile(r"\bпр\."), "прочее"),
]


# --------------------------------------------------------------------------- #
#  Token-level rules                                                           #
# --------------------------------------------------------------------------- #

_CURRENCY = {"$": ("dollar", "dollars", "cent", "cents"),
             "£": ("pound", "pounds", "penny", "pence"),
             "€": ("euro", "euros", "cent", "cents")}

_NUM_RE = re.compile(r"""
    (?P<currency>[$£€])?
    (?P<sign>-)?
    (?P<int>\d{1,3}(?:,\d{3})+|\d+)
    (?:\.(?P<frac>\d+))?
    (?P<ord>st|nd|rd|th)?
    (?P<pct>\s?%)?
    (?P<suffix>'s|s)?
    """, re.VERBOSE)

_TIME_RE = re.compile(r"^(\d{1,2}):(\d{2})$")


def _read_en_number(m: "re.Match[str]", prev_word: str) -> str:
    ival = int(m.group("int").replace(",", ""))
    sign = "minus " if m.group("sign") else ""
    cur, frac, pct = m.group("currency"), m.group("frac"), m.group("pct")
    if m.group("ord"):
        return sign + _en_ordinal_words(ival)
    if cur:
        one, many, cone, cmany = _CURRENCY[cur]
        out = sign + en_number_to_words(ival) + " " + (one if ival == 1 else many)
        if frac:
            cents = int(frac[:2].ljust(2, "0"))
            out += " " + en_number_to_words(cents) + " " + (
                cone if cents == 1 else cmany)
        return out
    body = en_number_to_words(ival)
    # bare 4-digit integers in date-looking positions read as years
    if (not frac and not pct and "," not in m.group("int")
            and len(m.group("int")) == 4 and 1000 <= ival <= 2199):
        body = _en_year_words(ival)
    if frac:
        body += " point " + _en_digits(frac)
    if pct:
        body += " percent"
    suffix = m.group("suffix")
    if suffix == "'s":
        body += "'s"
    elif suffix == "s":  # decades/plurals: "the 1990s", "in twos"
        body = (body[:-1] + "ies") if body.endswith("y") else body + "s"
    return sign + body


def _read_ru_number(m: "re.Match[str]") -> str:
    ival = int(m.group("int").replace(",", ""))
    sign = "минус " if m.group("sign") else ""
    body = ru_number_to_words(ival)
    if m.group("frac"):
        body += " запятая " + " ".join(
            _RU_ONES_M[int(c)] for c in m.group("frac"))
    if m.group("pct"):
        body += " процентов" if _ru_plural(ival, ("а", "б", "в")) == "в" else (
            " процент" if ival % 10 == 1 and ival % 100 != 11 else " процента")
    return sign + body


def _norm_token(tok: str, lang: str, prev_word: str) -> str:
    """Normalize one whitespace token, preserving leading/trailing punct."""
    pre = tok[: len(tok) - len(tok.lstrip("\"'([{«"))]
    core = tok.strip("\"'()[]{}«»")
    post = tok[len(pre) + len(core):]
    if not core:
        return tok

    trail = ""
    while core and core[-1] in ".,;:!?…":
        trail = core[-1] + trail
        core = core[:-1]

    out: tp.Optional[str] = None
    tm = _TIME_RE.match(core)
    if tm and lang == "EN":
        h, mnt = int(tm.group(1)), int(tm.group(2))
        if h <= 24 and mnt < 60:
            out = en_number_to_words(h) + (
                " o'clock" if mnt == 0 else
                " oh " + en_number_to_words(mnt) if mnt < 10 else
                " " + en_number_to_words(mnt))
    if out is None:
        m = _NUM_RE.fullmatch(core)
        if m:
            # ordinal suffix swallowed the trailing period? keep trail as-is
            out = (_read_en_number(m, prev_word) if lang != "RU"
                   else _read_ru_number(m))
    if out is None and lang != "RU":
        low = core.lower()
        if low in _EN_ABBREV and (trail.startswith(".") or
                                  low not in _EN_DOT_ONLY and low in
                                  ("mr", "mrs", "dr", "vs", "etc")):
            if low == "st":
                # Saint before a capitalized word, street otherwise
                out = "saint"
            else:
                out = _EN_ABBREV[low]
            if trail.startswith("."):
                trail = trail[1:]
                # sentence-final "etc." keeps its stop
                if low == "etc" and not trail:
                    trail = "."
    if out is None:
        return tok
    return pre + out + trail + post


def normalize_text(text: str, lang: str = "EN") -> str:
    """Expand digits/abbreviations to spellable words; idempotent on
    already-normal text.  Punctuation and casing of untouched words are
    preserved so downstream pause insertion still sees the commas."""
    lang = (lang or "EN").upper()
    for rx, rep in (_RU_MULTI if lang == "RU" else _EN_MULTI):
        text = rx.sub(rep, text)
    toks = text.split()
    out: tp.List[str] = []
    prev = ""
    for i, tok in enumerate(toks):
        if lang != "RU" and tok.lower().rstrip(".,;:!?") == "st":
            # street after a capitalized/номер word, saint before one
            nxt = toks[i + 1] if i + 1 < len(toks) else ""
            word = "street" if prev[:1].isupper() or prev[:1].isdigit() \
                else "saint"
            trail = tok[len(tok.rstrip(".,;:!?")):].lstrip(".")
            out.append(word + trail)
            prev = tok
            continue
        out.append(_norm_token(tok, lang, prev))
        prev = tok
    return " ".join(out)
