"""Real-time / offline detection CLI, the port's copy of
`cough_detector_tpu/cli/detect.py`: flag-compatible with the reference
(reference: src/inference.py:454-503, run_detection.py), plus file input
and multi-stream modes the reference lacks.

    python -m cough_detector_tpu_torch.cli.detect --model CK --wav rec.wav
    python -m cough_detector_tpu_torch.cli.detect --model CK --wav a.wav b.wav [--streams N]
    python -m cough_detector_tpu_torch.cli.detect --model CK          # microphone
    python -m cough_detector_tpu_torch.cli.detect --list-devices

CK is a checkpoint directory of the port's trainer or a reference `.pt`.
One file scores every sliding window in 1024-window batches
(stream/offline.py); several files ride the lanes of one batched
StreamingDetector tick; the microphone runs through CoughDetectorInference.
Every mode runs on the card unless given `--device cpu`."""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Real-time cough detection")
    p.add_argument("--model", type=str, required=False,
                   help="Checkpoint: the port's checkpoint dir or a reference .pt")
    p.add_argument("--threshold", type=float, default=0.7)
    p.add_argument("--smoothing", type=int, default=3)
    p.add_argument("--debounce", type=float, default=0.5)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (or 'auto', the reference's "
                        "name) for the card, 'cpu' for the CPU")
    p.add_argument("--audio-device", type=int, default=None)
    p.add_argument("--backend", type=str, default="auto",
                   choices=["auto", "sounddevice", "pyaudio"])
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--quiet", action="store_true")
    # Beyond-reference modes:
    p.add_argument("--wav", type=str, default=None, nargs="+",
                   help="Run detection over wav file(s) instead of the "
                        "mic; several files score concurrently as lanes "
                        "of one batched device tick (see --streams)")
    p.add_argument("--streams", type=int, default=None,
                   help="Concurrent stream lanes for batched --wav "
                        "scoring (default: one lane per file, up to 64)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..stream import (
        CoughDetectorInference,
        RealtimeMicrophoneDetector,
        list_audio_devices,
    )

    if args.list_devices:
        list_audio_devices()
        return
    if not args.model:
        raise SystemExit("--model is required (unless --list-devices)")

    device = "cuda" if args.device == "auto" else args.device
    if args.wav:
        from ..data import audio_io
        from ..stream.detector import _load_checkpoint

        variables, config = _load_checkpoint(args.model)
        if len(args.wav) == 1 and args.streams in (None, 1):
            # Single file: every sliding window scores in 1024-window
            # batches (stream/offline.py), with the detections streaming
            # would give, minus the per-tick dispatch.
            from ..stream.offline import score_recording

            wave = audio_io.load_mono_16k(args.wav[0])
            events = score_recording(
                wave, variables, config,
                hop_duration=0.25,
                threshold=args.threshold,
                smoothing_window=args.smoothing,
                debounce_seconds=args.debounce,
                device=device,
            )
            if not events:
                print("No coughs detected.")
            for ev in events:
                print(
                    f"cough at t={ev.time_seconds:.2f}s "
                    f"(confidence {ev.confidence:.2%})"
                )
            return

        # Multi-file / --streams: files ride concurrent lanes of one
        # batched StreamingDetector tick, the serving engine driven from
        # the CLI. Lanes are zero-padded to a common length;
        # events whose window starts past a file's end are suppressed
        # (they score only padding).
        import numpy as np

        from ..stream.detector import StreamingDetector

        sr = config.features.sample_rate
        window_s = config.features.segment_duration
        paths = list(args.wav)
        n_lanes = args.streams or min(len(paths), 64)
        if n_lanes < 1:
            raise SystemExit("--streams must be >= 1")
        chunk = 1600
        det = StreamingDetector(
            variables=variables, config=config, num_streams=n_lanes,
            chunk_size=chunk, confidence_threshold=args.threshold,
            smoothing_window=args.smoothing,
            debounce_seconds=args.debounce, device=device,
        )
        total = 0
        for lo in range(0, len(paths), n_lanes):
            group = paths[lo : lo + n_lanes]
            waves = [audio_io.load_mono_16k(p, sr) for p in group]
            span = max(len(w) for w in waves)
            span = -(-span // chunk) * chunk
            batch = np.zeros((n_lanes, span), np.float32)
            for i, w in enumerate(waves):
                batch[i, : len(w)] = w
            det.reset()
            dets = det.process_chunk(batch)
            for d in sorted(dets, key=lambda d: (d.stream, d.time_seconds)):
                if d.stream >= len(group):
                    continue  # padding lane
                if d.time_seconds - window_s >= len(waves[d.stream]) / sr:
                    continue  # window held only padding
                total += 1
                print(
                    f"{group[d.stream]}: cough at "
                    f"t={d.time_seconds:.2f}s "
                    f"(confidence {d.confidence:.2%})"
                )
        if total == 0:
            print("No coughs detected.")
        return

    inference = CoughDetectorInference(
        model_path=args.model,
        device=device,
        confidence_threshold=args.threshold,
        smoothing_window=args.smoothing,
        debounce_seconds=args.debounce,
        verbose=not args.quiet,
    )
    detector = RealtimeMicrophoneDetector(
        inference_engine=inference,
        sample_rate=inference.config.get("sample_rate", 16000),
        device_index=args.audio_device,
        backend=args.backend,
    )
    detector.run()


if __name__ == "__main__":
    main()
