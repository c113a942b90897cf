"""PubTabDataSet: JSON-line (PubTabNet) table dataset — the port's copy of
pytorchocr_tpu/data/pubtab_dataset.py:13, with the same seeded sample and
shuffle order (`random.seed(seed)`), the opt-in decoded-image cache and the
retry of a failed sample (a random index at train, the next one at eval)."""

import json
import os
import random
import traceback

import numpy as np

from .imaug import create_operators, transform


class PubTabDataSet:
    def __init__(self, config, mode, logger, seed=None):
        self.logger = logger
        self.mode = mode.lower()

        global_config = config["Global"]
        dataset_config = dict(config[mode]["dataset"])
        loader_config = config[mode]["loader"]

        label_file_list = dataset_config.pop("label_file_list")
        data_source_num = len(label_file_list) if isinstance(label_file_list, list) else 1
        ratio_list = dataset_config.get("ratio_list", [1.0])
        if isinstance(ratio_list, (float, int)):
            ratio_list = [float(ratio_list)] * int(data_source_num)
        assert len(ratio_list) == data_source_num, (
            "The length of ratio_list should be the same as the file_list."
        )
        self.do_shuffle = loader_config["shuffle"]
        self.seed = seed
        logger.info("Initialize indexs of datasets:%s" % label_file_list)
        self.data_lines = self.get_image_info_list(label_file_list, ratio_list)
        if self.mode == "train" and self.do_shuffle:
            self.shuffle_data_random()
        self.ops = create_operators(dataset_config["transforms"], global_config)

        # opt-in decoded-image cache, as SimpleDataSet.cache_decoded
        self.cache_decoded = bool(dataset_config.get("cache_decoded", False))
        if self.cache_decoded and (
            not self.ops or type(self.ops[0]).__name__ != "DecodeImage"
        ):
            logger.warning(
                "cache_decoded: first transform is not DecodeImage — disabled"
            )
            self.cache_decoded = False
        self._decode_cache = {}
        self._decode_cache_bytes = 0
        self._decode_cache_cap = (
            int(dataset_config.get("cache_decoded_mb", 2048)) * 2**20
        )

    def get_image_info_list(self, file_list, ratio_list):
        if isinstance(file_list, str):
            file_list = [file_list]
        data_lines = []
        for idx, file in enumerate(file_list):
            with open(file, "rb") as f:
                lines = f.readlines()
                if self.mode == "train" or ratio_list[idx] < 1.0:
                    random.seed(self.seed)
                    lines = random.sample(lines, round(len(lines) * ratio_list[idx]))
                data_lines.extend(lines)
        return data_lines

    def shuffle_data_random(self):
        random.seed(self.seed)
        random.shuffle(self.data_lines)

    def __getitem__(self, idx):
        try:
            data_line = self.data_lines[idx].decode("UTF-8").strip("\n")
            info = json.loads(data_line)
            img_path = info["img_path"]
            cells = info["html"]["cells"].copy()
            structure = info["html"]["structure"]["tokens"].copy()
            data = {"img_path": img_path, "cells": cells, "structure": structure}
            if not os.path.exists(img_path):
                raise FileNotFoundError("{} does not exist!".format(img_path))
            ops = self.ops
            if self.cache_decoded:
                cached = self._decode_cache.get(img_path)
                if cached is not None:
                    data["image"] = cached.copy()
                    ops = self.ops[1:]
                else:
                    with open(img_path, "rb") as f:
                        data["image"] = f.read()
                    data = transform(data, self.ops[:1])
                    if data is None:
                        raise ValueError("decode failed for %s" % img_path)
                    decoded = data["image"]
                    if (
                        self._decode_cache_bytes + decoded.nbytes
                        <= self._decode_cache_cap
                    ):
                        self._decode_cache[img_path] = decoded.copy()
                        self._decode_cache_bytes += decoded.nbytes
                    ops = self.ops[1:]
            else:
                with open(img_path, "rb") as f:
                    data["image"] = f.read()
            outs = transform(data, ops)
        except Exception:
            self.logger.error(
                "When parsing line {}, error happened with msg: {}".format(
                    self.data_lines[idx], traceback.format_exc()
                )
            )
            outs = None
        if outs is None:
            rnd_idx = (
                np.random.randint(len(self))
                if self.mode == "train"
                else (idx + 1) % len(self)
            )
            return self.__getitem__(rnd_idx)
        return outs

    def __len__(self):
        return len(self.data_lines)
