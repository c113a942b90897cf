"""Result drawing of the deploy CLIs — a copy of deploy/utils.py:23-138
(`_font` with its CJK font search, `show_image` with its headless guard,
`draw_det_res`, `draw_rec_res`, `draw_cls_res`, `draw_ocr_res`): cv2 and
PIL only, on the host; the same pixels as the JAX package's for the same
boxes, texts and font (tests/test_torch_deploy_images.py).

Fonts: `--font_path` for CJK text; without it, the first CJK-capable
system font of `_CJK_FONT_GLOBS` (the JAX list; its last entry is a
`fonts/` directory beside this file, which the port does not ship), else
PIL's default bitmap font with a one-time warning (CJK glyphs then render
as boxes). Recognition never reads a font: only the res_*.jpg images do.
"""

import glob
import os
import warnings

import cv2
import numpy as np
from PIL import Image, ImageDraw, ImageFont

__all__ = ["draw_cls_res", "draw_det_res", "draw_ocr_res", "draw_rec_res", "show_image"]

# Common CJK-capable font locations across distros (first hit wins).
_CJK_FONT_GLOBS = [
    "/usr/share/fonts/**/NotoSansCJK*.ttc",
    "/usr/share/fonts/**/NotoSansCJK*.otf",
    "/usr/share/fonts/**/NotoSerifCJK*.ttc",
    "/usr/share/fonts/**/wqy*.ttc",
    "/usr/share/fonts/**/wqy*.ttf",
    "/usr/share/fonts/**/DroidSansFallback*.ttf",
    "/usr/share/fonts/**/SourceHanSans*.otf",
    "/System/Library/Fonts/PingFang.ttc",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts", "*.tt[fc]"),
]

_warned_no_cjk = False


def _find_cjk_font():
    for pattern in _CJK_FONT_GLOBS:
        hits = sorted(glob.glob(pattern, recursive=True))
        if hits:
            return hits[0]
    return None


def _font(font_path, size, want_cjk=True):
    if font_path:
        try:
            return ImageFont.truetype(font_path, size, encoding="UTF-8")
        except Exception:
            warnings.warn("could not load font %r; falling back" % font_path)
    if want_cjk:
        found = _find_cjk_font()
        if found:
            try:
                return ImageFont.truetype(found, size, encoding="UTF-8")
            except Exception:
                pass
        else:
            global _warned_no_cjk
            if not _warned_no_cjk:
                _warned_no_cjk = True
                warnings.warn(
                    "no CJK-capable font found: Chinese characters in result "
                    "visualizations will render as placeholder boxes. Install "
                    "one (e.g. apt install fonts-noto-cjk) or pass "
                    "--font_path /path/to/font.ttf (the reference ships "
                    "fs_GB2312.ttf for this). Recognition output text in the "
                    "res_*.txt files is unaffected."
                )
    try:
        return ImageFont.load_default(size)
    except TypeError:  # older PIL
        return ImageFont.load_default()


def show_image(title, img):
    """cv2.imshow guarded for headless environments (no DISPLAY -> Qt
    aborts the process); degrades to a warning instead."""
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        print("[warn] --show ignored: no display available (results are saved to disk)")
        return
    cv2.imshow(title, img)
    cv2.waitKey(0)


def draw_det_res(dt_boxes, img_path, save_path):
    img = cv2.imdecode(np.fromfile(img_path, dtype=np.uint8), cv2.IMREAD_COLOR)
    if len(dt_boxes) > 0:
        for box in dt_boxes:
            box = np.asarray(box).astype(np.int32).reshape((-1, 1, 2))
            cv2.polylines(img, [box], True, color=(255, 255, 0), thickness=2)
    cv2.imwrite(save_path, img)
    print("The detected Image saved in {}".format(save_path))
    return img


def draw_rec_res(text, prob, img_path, save_path, font_path=None):
    pilimg = Image.open(str(img_path)).convert("RGB")
    w, h = pilimg.size
    draw = ImageDraw.Draw(pilimg)
    font = _font(font_path, int(max(min(30, h - 5), 10)))
    draw.text((2, 2), "{},{}".format(text, prob), (0, 0, 255), font=font)
    pilimg.save(save_path)
    img = cv2.cvtColor(np.array(pilimg), cv2.COLOR_RGB2BGR)
    print("The Rec_res Image saved in {}".format(save_path))
    return img


def draw_cls_res(pred_cls, prob, img_path, save_path, font_path=None):
    return draw_rec_res(pred_cls, prob, img_path, save_path, font_path)


def draw_ocr_res(ocr_res, img_path, save_path, font_path=None):
    img = cv2.imdecode(np.fromfile(img_path, dtype=np.uint8), cv2.IMREAD_COLOR)
    if len(ocr_res) > 0:
        for cur_res in ocr_res:
            ori_box, text, prob = cur_res
            box = np.asarray(ori_box).astype(np.int32).reshape((-1, 1, 2))
            cv2.polylines(img, [box], True, color=(255, 255, 0), thickness=2)
            pilimg = Image.fromarray(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            draw = ImageDraw.Draw(pilimg)
            h = min(cv2.minAreaRect(box.reshape((-1, 2)))[1])
            font = _font(font_path, int(max(min(30, h - 5), 10)))
            draw.text(
                (int(ori_box[0][0]), max(0, int(ori_box[0][1]) - 10)),
                "{},{}".format(text, prob),
                (0, 0, 255),
                font=font,
            )
            img = cv2.cvtColor(np.array(pilimg), cv2.COLOR_RGB2BGR)
    cv2.imwrite(save_path, img)
    print("The OCR_res Image saved in {}".format(save_path))
    return img
