"""MIS store + loader tests: roundtrip, codec parity, C++/Python parity,
ordering semantics, sharding, prefetch."""

import numpy as np
import pytest

from medical_image_segmentation_tpu.data.loader import (
    QUASI_RANDOM,
    RANDOM,
    SEQUENTIAL,
    Loader,
    make_order,
)
from medical_image_segmentation_tpu.data.store import (
    CODEC_JPEG,
    CODEC_PNG,
    CODEC_RAW,
    StoreReader,
    StoreWriter,
    write_store_from_dataset,
)


def _write_store(path, n=32, h=24, w=20, c=1, codec=CODEC_RAW, labeled=True):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, size=(n, h, w, c)).astype(np.uint8)
    with StoreWriter(str(path), channels=c, with_labels=labeled) as wtr:
        for i in range(n):
            wtr.add(imgs[i], label=i % 7, codec=codec)
    return imgs


class TestStoreRoundtrip:
    @pytest.mark.parametrize("c", [1, 3])
    def test_raw_roundtrip(self, tmp_path, c):
        p = tmp_path / "s.mis"
        imgs = _write_store(p, c=c)
        r = StoreReader(str(p))
        assert len(r) == 32
        for i in [0, 7, 31]:
            img, label = r[i]
            np.testing.assert_array_equal(img, imgs[i])
            assert label == i % 7

    def test_png_lossless_roundtrip(self, tmp_path):
        p = tmp_path / "s.mis"
        imgs = _write_store(p, codec=CODEC_PNG)
        r = StoreReader(str(p))
        np.testing.assert_array_equal(r[5][0], imgs[5])

    def test_jpeg_lossy_close(self, tmp_path):
        p = tmp_path / "s.mis"
        rng = np.random.default_rng(1)
        # smooth image so JPEG error is small
        base = rng.integers(80, 120, size=(1, 1, 1)).astype(np.uint8)
        img = np.tile(base, (32, 32, 1))
        with StoreWriter(str(p), channels=1) as w:
            w.add(img, codec=CODEC_JPEG, quality=95)
        r = StoreReader(str(p))
        got = r[0][0]
        assert got.shape == (32, 32, 1)
        assert np.abs(got.astype(int) - img.astype(int)).max() <= 3

    def test_labels_vector(self, tmp_path):
        p = tmp_path / "s.mis"
        _write_store(p, n=10)
        r = StoreReader(str(p))
        np.testing.assert_array_equal(r.labels, np.arange(10) % 7)

    def test_write_from_dataset(self, tmp_path):
        rng = np.random.default_rng(2)
        data = [(rng.integers(0, 255, size=(16, 16, 3)).astype(np.uint8), i) for i in range(5)]

        class DS:
            def __len__(self):
                return len(data)

            def __getitem__(self, i):
                return data[i]

        p = str(tmp_path / "ds.mis")
        n = write_store_from_dataset(p, DS(), channels=3)
        assert n == 5
        r = StoreReader(p)
        np.testing.assert_array_equal(r[3][0], data[3][0])

    @pytest.mark.parametrize("codec", [CODEC_RAW, CODEC_JPEG])
    def test_parallel_write_byte_identical(self, tmp_path, codec):
        """num_processes>1 must produce the SAME bytes as the serial path
        (workers encode, parent assembles in index order)."""
        rng = np.random.default_rng(3)
        data = [
            (rng.integers(0, 255, size=(16 + i % 3, 16, 1)).astype(np.uint8), i % 4)
            for i in range(23)
        ]

        class DS:
            def __len__(self):
                return len(data)

            def __getitem__(self, i):
                return data[i]

        p1, p4 = str(tmp_path / "serial.mis"), str(tmp_path / "par.mis")
        n1 = write_store_from_dataset(p1, DS(), channels=1, codec=codec, num_processes=1)
        n4 = write_store_from_dataset(p4, DS(), channels=1, codec=codec, num_processes=4)
        assert n1 == n4 == 23
        with open(p1, "rb") as a, open(p4, "rb") as b:
            assert a.read() == b.read()

    def test_max_resolution_downscales(self, tmp_path):
        class DS:
            def __len__(self):
                return 1

            def __getitem__(self, i):
                return np.zeros((100, 50, 1), np.uint8)

        p = str(tmp_path / "r.mis")
        write_store_from_dataset(p, DS(), channels=1, max_resolution=64)
        r = StoreReader(p)
        assert r[0][0].shape == (64, 32, 1)


class TestNativeLoader:
    def test_native_matches_python_reader(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = tmp_path / "s.mis"
        imgs = _write_store(p, n=16, codec=CODEC_RAW)
        ns = NativeStore(str(p))
        assert ns.num_samples == 16
        idxs = np.array([3, 0, 15, 7], np.int64)
        out, labels = ns.fetch(idxs, num_threads=2)
        for j, i in enumerate(idxs):
            np.testing.assert_array_equal(out[j], imgs[i])
            assert labels[j] == i % 7

    def test_native_png_decode_parity(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = tmp_path / "s.mis"
        imgs = _write_store(p, n=8, codec=CODEC_PNG)
        ns = NativeStore(str(p))
        out, _ = ns.fetch(np.arange(8, dtype=np.int64))
        np.testing.assert_array_equal(out, imgs)

    def test_native_jpeg_decode(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = tmp_path / "s.mis"
        img = np.tile(np.uint8(100), (32, 32, 1))
        with StoreWriter(str(p), channels=1) as w:
            w.add(img, codec=CODEC_JPEG, quality=95)
        ns = NativeStore(str(p))
        out, _ = ns.fetch(np.array([0], np.int64))
        assert np.abs(out[0].astype(int) - 100).max() <= 3


class TestOrdering:
    def test_sequential(self):
        np.testing.assert_array_equal(make_order(10, SEQUENTIAL, 0, 0), np.arange(10))

    def test_random_is_permutation_and_epoch_varies(self):
        o1 = make_order(100, RANDOM, 0, 0)
        o2 = make_order(100, RANDOM, 0, 1)
        assert sorted(o1) == list(range(100))
        assert not np.array_equal(o1, o2)

    def test_quasi_random_is_permutation(self):
        o = make_order(1000, QUASI_RANDOM, 3, 0)
        assert sorted(o) == list(range(1000))
        assert not np.array_equal(o, np.arange(1000))


class TestLoader:
    def test_batches_cover_shard(self, tmp_path):
        p = tmp_path / "s.mis"
        _write_store(p, n=32)
        loader = Loader(str(p), batch_size=8, order=RANDOM, use_native=False)
        seen = []
        for imgs, labels in loader:
            assert imgs.shape == (8, 24, 20, 1)
            seen.append(labels)
        assert len(seen) == 4

    def test_abandoned_iterator_then_close_joins_producer(self, tmp_path):
        """A consumer that breaks mid-epoch (e.g. the KNN bank-size cap) and
        then closes the loader must not leave the prefetch producer running
        an in-flight fetch against the just-unmapped store. close() joins."""
        p = tmp_path / "s.mis"
        _write_store(p, n=64)
        loader = Loader(str(p), batch_size=4, order=SEQUENTIAL, prefetch=2,
                        use_native=False)
        it = iter(loader)
        next(it)  # producer alive, decoding ahead
        # deliberately DON'T finalize `it` — mimic an abandoned generator
        # chain that a non-refcounting GC has not collected yet
        loader.close()
        assert not loader._producers
        # the underlying reader is closed; a racing fetch would have thrown
        with pytest.raises(Exception):
            loader._reader[0]
        del it

    def test_sharding_partitions(self, tmp_path):
        p = tmp_path / "s.mis"
        _write_store(p, n=32)
        l0 = Loader(str(p), batch_size=4, order=SEQUENTIAL, shard=(0, 2), use_native=False, prefetch=0)
        l1 = Loader(str(p), batch_size=4, order=SEQUENTIAL, shard=(1, 2), use_native=False, prefetch=0)
        assert l0.num_samples == 16 and l1.num_samples == 16
        lab0 = np.concatenate([l for _, l in l0])
        lab1 = np.concatenate([l for _, l in l1])
        all_labels = np.arange(32) % 7
        np.testing.assert_array_equal(np.sort(np.concatenate([lab0, lab1])), np.sort(all_labels))

    def test_native_loader_end_to_end(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = tmp_path / "s.mis"
        imgs = _write_store(p, n=16)
        loader = Loader(str(p), batch_size=16, order=SEQUENTIAL, use_native=True)
        out, labels = next(iter(loader))
        np.testing.assert_array_equal(out, imgs)

    def test_producer_errors_propagate(self, tmp_path):
        p = tmp_path / "s.mis"
        _write_store(p, n=8)
        loader = Loader(str(p), batch_size=4, use_native=False)
        loader._fetch = lambda idxs: (_ for _ in ()).throw(RuntimeError("decode boom"))
        with pytest.raises(RuntimeError, match="decode boom"):
            list(loader)


class TestPairedLoader:
    def test_pairs_stay_aligned_under_shuffle(self, tmp_path):
        from medical_image_segmentation_tpu.data.loader import PairedLoader

        rng = np.random.default_rng(7)
        # image i = constant i; mask i = constant i as well → alignment check
        with StoreWriter(str(tmp_path / "i.mis"), channels=1) as wi, \
             StoreWriter(str(tmp_path / "m.mis"), channels=1) as wm:
            for i in range(24):
                wi.add(np.full((8, 8, 1), i, np.uint8))
                wm.add(np.full((8, 8, 1), i, np.uint8))
        loader = PairedLoader(str(tmp_path / "i.mis"), str(tmp_path / "m.mis"),
                              batch_size=8, order=RANDOM, use_native=False, prefetch=0)
        seen = 0
        for imgs, msks in loader:
            np.testing.assert_array_equal(imgs.astype(np.float32), msks)
            seen += len(imgs)
        assert seen == 24

    def test_create_seg_store_end_to_end(self, tmp_path):
        import cv2

        from medical_image_segmentation_tpu.data.ingest.create_seg_store import build_seg_stores
        from medical_image_segmentation_tpu.data.loader import PairedLoader

        img_dir = tmp_path / "imgs"
        msk_dir = tmp_path / "msks"
        img_dir.mkdir()
        msk_dir.mkdir()
        rng = np.random.default_rng(8)
        for v in range(3):
            for s in range(4):
                name = f"la_{v:03d}_{s}.png"
                cv2.imwrite(str(img_dir / name), rng.integers(0, 255, (40, 40)).astype(np.uint8))
                cv2.imwrite(str(msk_dir / name), (rng.random((40, 40)) > 0.5).astype(np.uint8) * 255)
        counts = build_seg_stores(str(img_dir), str(msk_dir), str(tmp_path / "seg"),
                                  split_file=None, image_size=32)
        assert counts == {"train": 12}
        loader = PairedLoader(str(tmp_path / "seg_train_images.mis"),
                              str(tmp_path / "seg_train_masks.mis"),
                              batch_size=4, use_native=False, prefetch=0)
        imgs, msks = next(iter(loader))
        assert imgs.shape == (4, 32, 32, 1)
        assert set(np.unique(msks)) <= {0.0, 1.0}

    def test_datamodule_dispatches_to_paired_stores(self, tmp_path):
        import cv2

        from medical_image_segmentation_tpu.data.datamodules import get_datamodule
        from medical_image_segmentation_tpu.data.ingest.create_seg_store import build_seg_stores
        from medical_image_segmentation_tpu.data.loader import PairedLoader

        img_dir = tmp_path / "imgs"
        msk_dir = tmp_path / "msks"
        img_dir.mkdir()
        msk_dir.mkdir()
        rng = np.random.default_rng(9)
        for v in range(2):
            for s in range(4):
                name = f"la_{v:03d}_{s}.png"
                cv2.imwrite(str(img_dir / name), rng.integers(0, 255, (32, 32)).astype(np.uint8))
                cv2.imwrite(str(msk_dir / name), (rng.random((32, 32)) > 0.5).astype(np.uint8) * 255)
        build_seg_stores(str(img_dir), str(msk_dir), str(tmp_path / "seg"), image_size=32)
        dm = get_datamodule("DECATHLON_HEART")(
            images_dir=str(img_dir), masks_dir=str(msk_dir),
            image_size=32, store_prefix=str(tmp_path / "seg"),
        )
        loader = dm.loader("train", batch_size=4)
        assert isinstance(loader, PairedLoader)
        imgs, msks = next(iter(loader))
        assert imgs.shape == (4, 32, 32, 1) and msks.shape == (4, 32, 32, 1)


class TestCorruptedStore:
    def test_native_rejects_oob_offsets(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = str(tmp_path / "c.mis")
        _write_store(p, n=4)
        raw = bytearray(open(p, "rb").read())
        # clobber record 0's offset (bytes 64..72) to point past EOF
        import struct

        struct.pack_into("<Q", raw, 64, 2**40)
        open(p, "wb").write(bytes(raw))
        ns = NativeStore(p)
        with pytest.raises(IOError):
            ns.fetch(np.array([0], np.int64))

    def test_native_rejects_truncated_table(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = str(tmp_path / "t.mis")
        _write_store(p, n=8)
        raw = open(p, "rb").read()
        open(p, "wb").write(raw[:80])  # header + partial table
        with pytest.raises(IOError):
            NativeStore(p)

    def test_native_rejects_short_raw_payload(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("no native toolchain")
        p = str(tmp_path / "s.mis")
        _write_store(p, n=2)
        raw = bytearray(open(p, "rb").read())
        import struct

        struct.pack_into("<Q", raw, 64 + 8, 3)  # record 0 length = 3 bytes
        open(p, "wb").write(bytes(raw))
        ns = NativeStore(p)
        with pytest.raises(IOError):
            ns.fetch(np.array([0], np.int64))


class TestRGBConvention:
    def test_native_and_python_agree_on_rgb_jpeg(self, tmp_path):
        """Compressed 3-channel payloads are RGB-ordered: the C++ (libjpeg)
        and Python (cv2) decode paths must both return the ORIGINAL RGB
        array (regression test for a silent R/B swap on the native path)."""
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        p = str(tmp_path / "rgb.mis")
        # strongly asymmetric channels: R=200, G=90, B=20
        img = np.zeros((32, 32, 3), np.uint8)
        img[..., 0] = 200
        img[..., 1] = 90
        img[..., 2] = 20
        with StoreWriter(p, channels=3) as w:
            w.add(img, codec=CODEC_JPEG, quality=95)
            w.add(img, codec=CODEC_PNG)
        r = StoreReader(p)
        for i, tol in ((0, 6), (1, 0)):  # JPEG lossy, PNG exact
            got = r.image(i).astype(int)
            assert abs(got[16, 16, 0] - 200) <= tol and abs(got[16, 16, 2] - 20) <= tol, \
                f"python reader channel swap at sample {i}: {got[16,16]}"
        if get_lib() is not None:
            ns = NativeStore(p)
            out, _ = ns.fetch(np.array([0, 1], np.int64))
            for i, tol in ((0, 6), (1, 0)):
                px = out[i, 16, 16].astype(int)
                assert abs(px[0] - 200) <= tol and abs(px[2] - 20) <= tol, \
                    f"native reader channel swap at sample {i}: {px}"

    def test_rgb_jls_store_native_fetch(self, tmp_path):
        """3-channel JPEG-LS samples decode through the native loader.
        Regression: the C++ JPEG-LS decoder failed on every multi-component
        (ILV=0) stream — the next-SOS scan started past the marker the
        buffered bit reader had already touched — so RGB JLS stores written
        by StoreWriter raised mis_fetch errors at training time."""
        from medical_image_segmentation_tpu.data.store import CODEC_JLS
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("native toolchain unavailable")
        p = str(tmp_path / "rgb_jls.mis")
        rng = np.random.default_rng(11)
        imgs = rng.integers(0, 256, size=(6, 40, 40, 3)).astype(np.uint8)
        with StoreWriter(p, channels=3, with_labels=True) as w:
            for i in range(len(imgs)):
                w.add(imgs[i], label=i, codec=CODEC_JLS)
        ns = NativeStore(p)
        out, labels = ns.fetch(np.arange(len(imgs), dtype=np.int64), num_threads=2)
        np.testing.assert_array_equal(out, imgs)
        np.testing.assert_array_equal(labels, np.arange(len(imgs)))
        ns.close()


class TestU16Store:
    """16-bit (HU-native) stores — header FLAG_U16, codecs RAW/PNG16/JLS.
    The reference has no equivalent: its FFCV datasets are uint8 RGB only
    (`create_ffcv_subset.py:36-65` squashes 16-bit DICOM pixels to uint8)."""

    def _write_u16(self, path, n=9, h=40, w=48):
        from medical_image_segmentation_tpu.data.store import CODEC_JLS

        rng = np.random.default_rng(2)
        imgs = rng.integers(0, 65536, size=(n, h, w), dtype=np.uint16)
        codecs = [CODEC_RAW, CODEC_PNG, CODEC_JLS]
        with StoreWriter(str(path), channels=1, with_labels=True,
                         dtype=np.uint16) as wtr:
            for i in range(n):
                wtr.add(imgs[i], label=i, codec=codecs[i % 3])
        return imgs

    def test_python_roundtrip_all_codecs(self, tmp_path):
        p = tmp_path / "u16.mis"
        imgs = self._write_u16(p)
        r = StoreReader(str(p))
        assert r.header.sample_dtype == np.uint16
        for i in range(len(imgs)):
            got, label = r[i]
            assert got.dtype == np.uint16
            np.testing.assert_array_equal(got[..., 0], imgs[i])
            assert label == i

    def test_native_parity_all_codecs(self, tmp_path):
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("native toolchain unavailable")
        p = tmp_path / "u16.mis"
        imgs = self._write_u16(p)
        ns = NativeStore(str(p))
        assert ns.dtype == np.uint16
        out, labels = ns.fetch(np.arange(len(imgs), dtype=np.int64), num_threads=2)
        assert out.dtype == np.uint16
        np.testing.assert_array_equal(out[..., 0], imgs)
        np.testing.assert_array_equal(labels, np.arange(len(imgs)))
        ns.close()

    def test_native_fetch_views_matches_numpy_oracle(self, tmp_path):
        from medical_image_segmentation_tpu.data.host_precrop import (
            crop_resize_bilinear_np,
        )
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("native toolchain unavailable")
        p = tmp_path / "u16.mis"
        imgs = self._write_u16(p, n=3)
        params = np.array(
            [[[3.2, 4.1, 30.0, 35.0, 0.0], [0.0, 0.0, 40.0, 48.0, 1.0]]] * 3,
            np.float32)
        ns = NativeStore(str(p))
        views, _ = ns.fetch_views(np.arange(3, dtype=np.int64), params, (16, 16),
                                  num_threads=1)
        assert views.dtype == np.uint16
        for i in range(3):
            for v in range(2):
                y0, x0, ch, cw, flip = params[i, v]
                ref = crop_resize_bilinear_np(
                    imgs[i][..., None], float(y0), float(x0), float(ch),
                    float(cw), bool(flip), 16, 16)
                np.testing.assert_array_equal(views[i * 2 + v], ref)
        ns.close()

    def test_jls_crop_at_decode_matches_oracle(self, tmp_path):
        """JLS row-limited crop-at-decode (csrc/mis_loader.cpp::
        decode_jls16_rows): windows confined to the TOP of the image force
        the truncated entropy decode (y_hi << h), which must still produce
        views bit-identical to the full-decode numpy oracle — the contract
        VERDICT r3 item #5 prescribes. Covers u16 stores (native JLS u16
        payloads) and u8 stores (8-bit JLS payloads through the widening
        branch)."""
        from medical_image_segmentation_tpu.data.host_precrop import (
            crop_resize_bilinear_np,
        )
        from medical_image_segmentation_tpu.data.store import CODEC_JLS
        from medical_image_segmentation_tpu.data.store.native import NativeStore, get_lib

        if get_lib() is None:
            pytest.skip("native toolchain unavailable")
        rng = np.random.default_rng(9)
        # windows in the top third (+ one spanning past halfway): truncation
        # points vary per sample, none reach the last rows
        params = np.stack([
            np.array([[2.0, 3.0, 20.0, 24.0, 0.0], [0.5, 1.5, 14.0, 17.0, 1.0]]),
            np.array([[0.0, 0.0, 30.0, 40.0, 0.0], [7.0, 9.0, 51.0, 30.0, 1.0]]),
            np.array([[11.0, 2.0, 9.0, 60.0, 1.0], [1.0, 40.0, 25.0, 20.0, 0.0]]),
        ]).astype(np.float32)
        for dtype, hi in ((np.uint16, 65536), (np.uint8, 256)):
            imgs = rng.integers(0, hi, size=(3, 96, 80), dtype=dtype)
            p = str(tmp_path / f"jls_{dtype.__name__}.mis")
            with StoreWriter(p, channels=1, dtype=dtype) as wtr:
                for i in range(3):
                    wtr.add(imgs[i], codec=CODEC_JLS)
            ns = NativeStore(p)
            views, _ = ns.fetch_views(np.arange(3, dtype=np.int64), params,
                                      (16, 16), num_threads=1)
            assert views.dtype == dtype
            for i in range(3):
                for v in range(2):
                    y0, x0, ch, cw, flip = params[i, v]
                    ref = crop_resize_bilinear_np(
                        imgs[i][..., None], float(y0), float(x0), float(ch),
                        float(cw), bool(flip), 16, 16)
                    np.testing.assert_array_equal(
                        views[i * 2 + v], ref,
                        err_msg=f"dtype={dtype.__name__} i={i} v={v}")
            ns.close()

    def test_dtype_mismatch_rejected(self, tmp_path):
        """add() of the wrong dtype fails at write; u16 payloads cannot be
        JPEG-coded (8-bit codec)."""
        from medical_image_segmentation_tpu.data.store import CODEC_JLS

        rng = np.random.default_rng(3)
        img16 = rng.integers(0, 65536, size=(8, 8), dtype=np.uint16)
        with pytest.raises(ValueError):
            with StoreWriter(str(tmp_path / "a.mis"), channels=1) as w:
                w.add(img16)  # u16 image into a u8 store
        with pytest.raises(ValueError):
            with StoreWriter(str(tmp_path / "b.mis"), channels=1,
                             dtype=np.uint16) as w:
                w.add(img16, codec=CODEC_JPEG)
        with pytest.raises(ValueError):
            StoreWriter(str(tmp_path / "c.mis"), channels=3, dtype=np.uint16)
        # JLS precision is pinned by dtype: a dark u16 slice (max < 256)
        # must still round-trip as uint16
        dark = (img16 % 200).astype(np.uint16)
        with StoreWriter(str(tmp_path / "d.mis"), channels=1,
                         dtype=np.uint16) as w:
            w.add(dark, codec=CODEC_JLS)
        r = StoreReader(str(tmp_path / "d.mis"))
        got = r[0][0]
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got[..., 0], dark)

    def test_loader_end_to_end_u16(self, tmp_path):
        p = tmp_path / "u16.mis"
        imgs = self._write_u16(p)
        ld = Loader(str(p), batch_size=4, order=SEQUENTIAL, prefetch=0)
        assert ld.dtype == np.uint16
        batches = list(ld)
        assert batches[0][0].dtype == np.uint16
        np.testing.assert_array_equal(batches[0][0][..., 0], imgs[:4])
        ld.close()

    def test_create_store_bit_depth_16(self, tmp_path):
        """`create_store --bit_depth 16` builds a FLAG_U16 JLS store from
        DICOMs and from a curated 16-bit PNG dir; the DICOM path preserves
        the full normalize→BICUBIC→renormalize output at 16-bit scale."""
        import cv2

        from medical_image_segmentation_tpu.data.dicom import write_dicom
        from medical_image_segmentation_tpu.data.ingest import create_store

        rng = np.random.default_rng(4)
        dcm_dir = tmp_path / "dcm"
        dcm_dir.mkdir()
        arrs = []
        for i in range(3):
            a = rng.integers(0, 4096, size=(64, 64)).astype(np.uint16)
            arrs.append(a)
            write_dicom(str(dcm_dir / f"{i}.dcm"), a)
        out = str(tmp_path / "u16.mis")
        assert create_store.main(["--dicom_dir", str(dcm_dir), "--output", out,
                                  "--max_resolution", "64", "--bit_depth", "16",
                                  "--num_workers", "1"]) == 0
        r = StoreReader(out)
        assert r.header.sample_dtype == np.uint16
        # scan order is not defined — match each stored image to its source
        refs = []
        for a in arrs:
            a = a.astype(np.float32)
            refs.append(((a - a.min()) / (a.max() - a.min()) * 65535.0).astype(np.uint16))
        for i in range(len(arrs)):
            got = r.image(i)[..., 0]
            assert any(np.array_equal(got, ref) for ref in refs), \
                f"store sample {i} matches no source DICOM"

        # curated 16-bit PNG dir → u16 store, full range preserved (no /256)
        png_dir = tmp_path / "png"
        png_dir.mkdir()
        img16 = rng.integers(0, 65536, size=(48, 48), dtype=np.uint16)
        cv2.imwrite(str(png_dir / "a.png"), img16)
        out2 = str(tmp_path / "png_u16.mis")
        assert create_store.main(["--png_dir", str(png_dir), "--output", out2,
                                  "--bit_depth", "16"]) == 0
        r2 = StoreReader(out2)
        assert r2.header.sample_dtype == np.uint16
        np.testing.assert_array_equal(r2.image(0)[..., 0], img16)


def test_native_build_key_covers_command_compiler_and_cpu():
    """A library built under other flags, by another compiler, or for
    another CPU (-march=native) must not be loaded: each changes the key."""
    from medical_image_segmentation_tpu.data.store import native

    def key(jpeg=True, png=True, version="g++ 13.3.0", cpu="flags: avx2"):
        return native.build_key(native.build_command("/x/out.so", "g++", jpeg, png), version, cpu)

    assert key() == key()
    assert native.build_key(native.build_command("/y/other.so"), "g++ 13.3.0", "flags: avx2") == key()
    assert "-march=native" in native.build_command("out.so")
    assert "-DMIS_NO_JPEG" in native.build_command("out.so", jpeg=False)
    assert len({key(), key(jpeg=False), key(png=False), key(version="g++ 12"),
                key(cpu="flags: avx512f")}) == 5
