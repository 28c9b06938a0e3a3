"""Listening reports and preference tests (static HTML; the port's copy of
``ezaudio_tpu/audio/report.py``, numpy and scipy only).

Equivalents of reference ``audiotools/post.py`` (HTML audio comparison
tables) and the data model of ``audiotools/preference.py`` (AB/MUSHRA
preference tests; the reference wraps gradio, which the project does not use —
the test protocol, randomization and result CSV are implemented here and
render to a self-contained static page).
"""

from __future__ import annotations

import base64
import html
import io
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

def _audio_tag(wav: np.ndarray, sr: int) -> str:
    buf = io.BytesIO()
    from scipy.io import wavfile

    wavfile.write(buf, sr, np.asarray(wav, np.float32))
    b64 = base64.b64encode(buf.getvalue()).decode()
    return (f'<audio controls preload="none">'
            f'<source src="data:audio/wav;base64,{b64}" type="audio/wav">'
            f"</audio>")


def audio_table(samples: Dict[str, Dict[str, np.ndarray]], sr: int,
                title: str = "ezaudio-tpu listening report") -> str:
    """Build an HTML table: rows = sample names, columns = condition names
    (post.py:12 audio_table equivalent, with embedded base64 audio)."""
    conditions: List[str] = sorted({c for row in samples.values() for c in row})
    head = "".join(f"<th>{html.escape(c)}</th>" for c in conditions)
    rows = []
    for name, row in samples.items():
        cells = "".join(
            f"<td>{_audio_tag(row[c], sr) if c in row else '—'}</td>"
            for c in conditions)
        rows.append(f"<tr><td><b>{html.escape(str(name))}</b></td>{cells}</tr>")
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title>
<style>body{{font-family:sans-serif}}table{{border-collapse:collapse}}
td,th{{border:1px solid #ccc;padding:6px}}</style></head>
<body><h2>{html.escape(title)}</h2>
<table><tr><th>sample</th>{head}</tr>{''.join(rows)}</table></body></html>"""


def write_report(path: str, samples: Dict[str, Dict[str, np.ndarray]],
                 sr: int, **kw) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(audio_table(samples, sr, **kw))
    return path


class PreferenceTest:
    """AB(X) preference-test data model (preference.py:239-600 equivalent):
    blinded, order-randomized condition pairs with a CSV result sink."""

    def __init__(self, conditions: Sequence[str], samples: Sequence[str],
                 seed: int = 0, results_csv: Optional[str] = None):
        assert len(conditions) >= 2
        self.conditions = list(conditions)
        self.samples = list(samples)
        self.results_csv = results_csv
        rnd = random.Random(seed)
        self.trials = []
        for s in self.samples:
            pair = rnd.sample(self.conditions, 2)
            self.trials.append({"sample": s, "A": pair[0], "B": pair[1]})
        if results_csv and not os.path.exists(results_csv):
            with open(results_csv, "w") as f:
                f.write("user,sample,A,B,choice\n")

    def record(self, user: str, trial_idx: int, choice: str):
        t = self.trials[trial_idx]
        assert choice in ("A", "B", "tie")
        if self.results_csv:
            with open(self.results_csv, "a") as f:
                f.write(f"{user},{t['sample']},{t['A']},{t['B']},{choice}\n")
        return {**t, "choice": choice}

    def tally(self) -> Dict[str, int]:
        import csv

        wins = {c: 0 for c in self.conditions}
        if not self.results_csv or not os.path.exists(self.results_csv):
            return wins
        with open(self.results_csv) as f:
            for row in csv.DictReader(f):
                if row["choice"] in ("A", "B"):
                    wins[row[row["choice"]]] += 1
        return wins

    def render_html(self, audio: Dict[str, Dict[str, np.ndarray]], sr: int
                    ) -> str:
        """Blinded trial page: conditions shown only as A/B."""
        blocks = []
        for i, t in enumerate(self.trials):
            a = _audio_tag(audio[t["sample"]][t["A"]], sr)
            b = _audio_tag(audio[t["sample"]][t["B"]], sr)
            blocks.append(
                f"<div><h3>Trial {i}</h3>A: {a} &nbsp; B: {b}</div>")
        return ("<!doctype html><html><body><h2>Preference test</h2>"
                + "".join(blocks) + "</body></html>")


# ---------------------------------------------------------------------------
# MUSHRA (ITU-R BS.1534) listening-test harness
# (reference preference.py:239-600 wraps gradio, absent here — the full
# protocol renders to a self-contained static page with JS sliders and a
# CSV export; ingest/stats close the loop)
# ---------------------------------------------------------------------------

def _lowpass_anchor(wav: np.ndarray, sr: int, cutoff: float = 3500.0
                    ) -> np.ndarray:
    """BS.1534 low-quality anchor: 3.5 kHz low-passed reference."""
    from ezaudio_tpu_torch.data.wav_aug import lowpass_biquad

    x = np.asarray(wav, np.float32)[None, None, :]
    for _ in range(2):
        x = lowpass_biquad(x, sr, cutoff)
    return x[0, 0]


class MUSHRATest:
    """MUSHRA protocol: per trial the listener rates the hidden reference,
    a 3.5 kHz anchor and every condition on a 0-100 scale against an open
    reference.  Systems are shuffled per trial; results export as CSV from
    the page; :meth:`ingest` + :meth:`stats` compute per-condition means,
    95% CIs and BS.1534 post-screening (raters who score the hidden
    reference below 90 in >15% of trials are excluded)."""

    ANCHOR = "__anchor__"
    HIDDEN_REF = "__reference__"

    def __init__(self, conditions: Sequence[str], samples: Sequence[str],
                 seed: int = 0):
        assert len(conditions) >= 1
        self.conditions = list(conditions)
        self.samples = list(samples)
        rnd = random.Random(seed)
        self.trials = []
        for s in self.samples:
            systems = [self.HIDDEN_REF, self.ANCHOR] + self.conditions
            order = systems[:]
            rnd.shuffle(order)
            self.trials.append({"sample": s, "order": order})

    # -- page ------------------------------------------------------------
    def render_html(self, audio: Dict[str, Dict[str, np.ndarray]], sr: int,
                    title: str = "MUSHRA listening test") -> str:
        """``audio[sample][condition]`` plus ``audio[sample]['reference']``.
        The hidden reference and anchor are derived from 'reference'."""
        blocks = []
        key_rows = []
        for i, t in enumerate(self.trials):
            ref = np.asarray(audio[t["sample"]]["reference"], np.float32)
            blocks.append(f"<div class='trial'><h3>Trial {i} — "
                          f"{html.escape(str(t['sample']))}</h3>"
                          f"<p>Reference: {_audio_tag(ref, sr)}</p>")
            for j, sys_name in enumerate(t["order"]):
                if sys_name == self.HIDDEN_REF:
                    wav = ref
                elif sys_name == self.ANCHOR:
                    wav = _lowpass_anchor(ref, sr)
                else:
                    wav = audio[t["sample"]][sys_name]
                blocks.append(
                    f"<div>System {j}: {_audio_tag(wav, sr)} "
                    f"<input type='range' min='0' max='100' value='50' "
                    f"id='r{i}_{j}' oninput='document.getElementById("
                    f"\"v{i}_{j}\").innerText=this.value'> "
                    f"<span id='v{i}_{j}'>50</span></div>")
                key_rows.append((i, j, t["sample"], sys_name))
            blocks.append("</div>")
        import json as _json

        # json-encode names and break '</' so a name containing
        # '</script>' can neither terminate the script element nor inject
        # markup into the page
        key_js = ",".join(
            "[{},{},{},{}]".format(
                i, j,
                _json.dumps(str(sample)).replace("</", "<\\/"),
                _json.dumps(str(name)).replace("</", "<\\/"))
            for i, j, sample, name in key_rows)
        script = f"""<script>
const KEY = [{key_js}];
function exportCSV() {{
  const user = document.getElementById('user').value || 'anon';
  let csv = 'user,trial,sample,system,score\\n';
  for (const [i, j, sample, name] of KEY) {{
    const v = document.getElementById('r' + i + '_' + j).value;
    csv += user + ',' + i + ',' + sample + ',' + name + ',' + v + '\\n';
  }}
  const a = document.createElement('a');
  a.href = URL.createObjectURL(new Blob([csv], {{type: 'text/csv'}}));
  a.download = 'mushra_' + user + '.csv';
  a.click();
}}
</script>"""
        return (f"<!doctype html><html><head><meta charset='utf-8'>"
                f"<title>{html.escape(title)}</title>"
                f"<style>body{{font-family:sans-serif}}"
                f".trial{{border:1px solid #ccc;margin:8px;padding:8px}}"
                f"</style></head><body><h2>{html.escape(title)}</h2>"
                f"<p>Rate each system against the reference "
                f"(100 = identical).</p>"
                f"<p>Name: <input id='user'></p>"
                + "".join(blocks)
                + "<button onclick='exportCSV()'>Export results</button>"
                + script + "</body></html>")

    def write(self, path: str, audio, sr: int, **kw) -> str:
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.render_html(audio, sr, **kw))
        return path

    # -- analysis ----------------------------------------------------------
    @staticmethod
    def ingest(csv_paths: Sequence[str]) -> List[Dict]:
        import csv as _csv

        rows = []
        for p in csv_paths:
            with open(p) as f:
                rows.extend(_csv.DictReader(f))
        for r in rows:
            r["score"] = float(r["score"])
        return rows

    def stats(self, rows: List[Dict], screen: bool = True) -> Dict[str, Dict]:
        """Per-system mean, std, 95% CI.  ``screen`` applies BS.1534
        post-screening: drop raters scoring the hidden reference < 90 in
        more than 15% of their trials."""
        if screen:
            by_user: Dict[str, List[float]] = {}
            for r in rows:
                if r["system"] == self.HIDDEN_REF:
                    by_user.setdefault(r["user"], []).append(r["score"])
            bad = {u for u, ss in by_user.items()
                   if np.mean([s < 90 for s in ss]) > 0.15}
            rows = [r for r in rows if r["user"] not in bad]
        out: Dict[str, Dict] = {}
        systems = sorted({r["system"] for r in rows})
        for sys_name in systems:
            ss = np.array([r["score"] for r in rows
                           if r["system"] == sys_name], np.float64)
            n = len(ss)
            mean = float(ss.mean()) if n else float("nan")
            std = float(ss.std(ddof=1)) if n > 1 else 0.0
            ci = 1.96 * std / np.sqrt(n) if n > 1 else 0.0
            out[sys_name] = {"mean": mean, "std": std, "ci95": ci, "n": n}
        return out
