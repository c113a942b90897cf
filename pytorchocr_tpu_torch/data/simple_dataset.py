"""SimpleDataSet: line-per-sample `img_path \\t label` files — the port's copy
of pytorchocr_tpu/data/simple_dataset.py:13, with the same seeded sample and
shuffle order (`random.seed(seed)`) and the opt-in decode / eval caches."""

import os
import random
import traceback

import numpy as np

from .imaug import create_operators, transform


class SimpleDataSet:
    def __init__(self, config, mode, logger, seed=None):
        self.logger = logger
        self.mode = mode.lower()

        global_config = config["Global"]
        dataset_config = dict(config[mode]["dataset"])
        loader_config = config[mode]["loader"]

        self.delimiter = dataset_config.get("delimiter", "\t")
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
        self.data_idx_order_list = list(range(len(self.data_lines)))
        if self.mode == "train" and self.do_shuffle:
            self.shuffle_data_random()
        self.ops = create_operators(dataset_config["transforms"], global_config)

        # Opt-in decoded-image cache (dataset.cache_decoded: true): image
        # decode (cv2.imdecode) is deterministic per path and costs
        # ~30ms/sample for PNG pages on this host — every epoch re-pays it.
        # Caching the FIRST op's output (must be DecodeImage) removes that
        # from the per-epoch reader cost for small benchmark datasets;
        # bounded by cache_decoded_mb (default 2048).  Augs receive a copy
        # so in-place mutations can't poison the cache.  With
        # worker_mode: process each forked worker holds its own cache —
        # prefer thread workers when enabling this.
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

        # Opt-in full-pipeline cache (dataset.cache_transformed: true),
        # EVAL ONLY: eval transform chains are deterministic per sample
        # (no stochastic augs), so the final KeepKeys tuple can be cached
        # outright — every epoch-gated eval after the first skips decode +
        # resize + normalize entirely.  Train chains are stochastic per
        # epoch and must not be cached.
        self.cache_transformed = bool(
            dataset_config.get("cache_transformed", False)
        )
        if self.cache_transformed and self.mode == "train":
            logger.warning(
                "cache_transformed is eval-only (train augs are stochastic)"
                " — disabled"
            )
            self.cache_transformed = False
        self._out_cache = {}
        self._out_cache_bytes = 0
        self._out_cache_cap = (
            int(dataset_config.get("cache_transformed_mb", 2048)) * 2**20
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

    def get_ext_data(self):
        """Extra samples for CopyPaste (reference simple_dataset.py:64-91)."""
        ext_data_num = 0
        for op in self.ops:
            if hasattr(op, "ext_data_num"):
                ext_data_num = getattr(op, "ext_data_num")
                break
        load_data_ops = self.ops[:2]
        ext_data = []
        while len(ext_data) < ext_data_num:
            file_idx = self.data_idx_order_list[np.random.randint(len(self))]
            data_line = self.data_lines[file_idx].decode("UTF-8")
            substr = data_line.strip("\n").split(self.delimiter)
            img_path, label = substr[0], substr[1]
            if not os.path.exists(img_path):
                continue
            data = {"img_path": img_path, "label": label}
            with open(img_path, "rb") as f:
                data["image"] = f.read()
            data = transform(data, load_data_ops)
            if data is None or data["polys"].shape[1] != 4:
                continue
            ext_data.append(data)
        return ext_data

    def __getitem__(self, idx):
        file_idx = self.data_idx_order_list[idx]
        if self.cache_transformed:
            cached = self._out_cache.get(file_idx)
            if cached is not None:
                return cached
        data_line = self.data_lines[file_idx]
        try:
            data_line = data_line.decode("UTF-8")
            substr = data_line.strip("\n").split(self.delimiter)
            img_path, label = substr[0], substr[1]
            data = {"img_path": img_path, "label": label}
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
            data["ext_data"] = self.get_ext_data()
            outs = transform(data, ops)
        except Exception:
            self.logger.error(
                "When parsing line {}, error happened with msg: {}".format(
                    data_line, traceback.format_exc()
                )
            )
            outs = None
        if outs is None:
            # eval keeps a deterministic fallback index; train resamples
            rnd_idx = (
                np.random.randint(len(self))
                if self.mode == "train"
                else (idx + 1) % len(self)
            )
            return self.__getitem__(rnd_idx)
        if self.cache_transformed:
            nbytes = sum(
                a.nbytes for a in outs if isinstance(a, np.ndarray)
            )
            if self._out_cache_bytes + nbytes <= self._out_cache_cap:
                self._out_cache[file_idx] = outs
                self._out_cache_bytes += nbytes
        return outs

    def __len__(self):
        return len(self.data_idx_order_list)
