"""Minimal HTML gallery writer (a copy of `t2onet_tpu.evals.html`, held
equal by a test).

Same capability as the reference's dominate-based utils/html.py:6-49
(add_header / add_images rows with captions / save), without the dominate
dependency.
"""

from __future__ import annotations

import html as _html
import os
from typing import List, Optional, Sequence


class HTML:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.refresh = refresh
        os.makedirs(self.img_dir, exist_ok=True)
        self._body: List[str] = []

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str):
        self._body.append(f"<h3>{_html.escape(text)}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str],
                   links: Optional[Sequence[str]] = None, width: int = 256):
        links = links or ims
        cells = []
        for im, txt, link in zip(ims, txts, links):
            cells.append(
                "<td style='text-align:center;vertical-align:top'>"
                f"<a href='images/{link}'>"
                f"<img src='images/{im}' width='{width}'></a><br>"
                f"<span style='font-size:12px'>{_html.escape(str(txt))}</span>"
                "</td>")
        self._body.append(
            "<table style='border-collapse:collapse;margin:8px'><tr>"
            + "".join(cells) + "</tr></table>")

    def save(self):
        meta = (f"<meta http-equiv='refresh' content='{self.refresh}'>"
                if self.refresh else "")
        doc = (f"<!doctype html><html><head>{meta}"
               f"<title>{_html.escape(self.title)}</title></head><body>"
               + "\n".join(self._body) + "</body></html>")
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)
