#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``certifiedgpt_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on any failure:

1. Device: requires CUDA, prints the card's name and power limit, and turns
   TF32 off for float32 matmuls and convolutions.
2. Build: compiles the CUDA kernels from ``certifiedgpt_tpu_torch/csrc/``
   (``nvcc``, sm_90a) and prints the build seconds and ptxas' summary
   (registers, spills, shared memory, performance warnings), with a line of
   registers and spills for each instance of the W8A8 GEMM kernel (with
   the IGMMA instructions, the int8 wgmma, in its SASS: each instance must
   have some), of the weight-only kernel (bf16 and f32), of the int8-KV
   kernels (the prefill's, the decode's, the tiled one) (also in their
   ``kernels`` records, ``ptxas``).
3. Kernels: calls each kernel's wrapper at the main path's
   shapes, holds the result against its plain PyTorch version on the same
   card, and times the kernel, the plain version and, where one PyTorch call
   computes the same function, that call (CUDA events): the cls-split kernel
   (one launch: the patch rows and the cls row, the latter also against its
   own plain version); the LN + row-quant and GELU + row-quant kernels at
   the patch and cls streams' row counts (98304 and 96) and at 1 and 4097
   rows and at the eval and train batches' patch and cls streams (8192 and
   8, 49152 and 48 rows),
   each input with a row of zeros, timed on N(0, 1) and N(0, 3^2)
   rows; the flash kernel at
   [96, 1025, 16, 88] in both layouts and causal at [4, 333, 16, 88]; the
   explicit-scale cls-split form at [96, 16, 1025, 88]; the noise kernel at
   96 copies of a 448x448x3 image. Tolerances: int8 codes one step apart on
   at most 1e-4 of the elements and row scales within 1e-6 relative against
   the plain versions that repeat the kernels' arithmetic (the LayerNorm's;
   the GELU's with the A-S erf), one step on 1e-3 and 1e-2 against the
   exact-erf GELU; attention
   within atol 2e-2 (bf16) and 1e-2 relative (Frobenius); noise: values
   within 1e-5 of the plain version on the same seed words at the main
   shape and at odd sizes down to one element, moments of (out - x) / sigma
   within 0.01 of 0 and 1, sigma = 0 exact; the noise kernel's SASS
   instructions an element and their time at the issue rate are printed.
   Then the kernels of the ops that XLA fuses for the JAX package: the
   W8A8 product (phase 21, below); the W8A8 epilogue alone (the
   row-parallel dense's rescale) at the ViT's and the prefill's products
   and at 1 and 8 rows, bit for bit against its plain chain; quantize_rows' kernel at
   the ViT's proj input, the prefill's inputs, the KV cache's rows and at
   1 and 8 rows, bit for bit; the weight-only int8 product at 96, 8, 1
   and 9216 rows of the decoder's three weight shapes, within
   ``INT8_MATMUL_REL_LIMIT`` (relative Frobenius), timed also against the
   bf16 copy + matmul it replaces and cuBLAS on a bf16 weight, its bf16
   and f32 instances' SASS holding no I2F (``sass_count.py``; the tiled
   int8-KV kernel's count is recorded); the entry
   ``multi_head_attention_kv8`` over the int8 KV cache at the certify and
   eval prefills (the prefill's kernel with no rows to write), eval's and a
   caption's decode rows and a lone row at the certify batch (the decode
   kernel with nothing to write, timed at that row eager and from a CUDA
   graph against its plain version, the tiled kernel on the same row and
   ``scaled_dot_product_attention`` on a dequantized bf16 cache; in the
   decode kernel's record) and grouped-query heads, within the attention
   limits, a fully masked row giving zeros, each call one launch of the
   kernel ``ops/attention.py::kv8_kernel`` names, the cache unchanged. Then
   the tiled kernel (``csrc/attention_kv8.cu``, record ``attention_kv8``)
   through ``prefill_attention_kv8`` on f32 at the certify prefill, eval's
   and a 2048-slot cache at offset 1900: one launch, the cache bit for bit
   its plain version's, the output within the attention limits; each timed
   eager and from a CUDA graph against its plain version, the launches it
   replaces (``quantize_rows`` of k and v, the four slice writes, the
   attention) and ``scaled_dot_product_attention`` on a dequantized f32
   cache, with its launch plan and its bounds (its three bf16 products at
   the bf16 peak; f32 FMAs at the f32 peak beside). Then the prefill's
   kernel (``prefill_attention_kv8``: the
   new k and v rows quantized into the cache and the attention over it, one
   launch, ``csrc/attention_kv8_prefill.cu``) at the certify prefill, eval's,
   a caption's (batch 1), grouped-query heads and a 2048-position cache at an
   offset: the cache's codes and scales bit for bit its plain version's,
   the output within the attention limits, a fully masked row giving zeros,
   its SASS holding no I2F; each case timed eager and alone (from a CUDA
   graph) against the sequence it replaced (``quantize_rows`` of k and v,
   the four slice writes, ``multi_head_attention_kv8``; its quantization
   and writes apart) and ``scaled_dot_product_attention`` on a dequantized
   bf16 cache, with its launch plan and a bound that counts the write.
   Then the decode step's kernel (``decode_attention_kv8``: the step's k
   and v quantized into the cache and the attention over it, one launch)
   at the certify decode, a caption's (batch 1), eval's, grouped-query
   heads and a 2048-position cache: the cache's codes and scales bit for
   bit its plain version's, the output within the attention limits, a
   fully masked row giving zeros, its SASS holding no I2F; timed eager and
   from a CUDA graph against its plain version, the sequence it replaced
   (``quantize_rows`` of k and v, the four slice writes, the attention
   launch) and ``scaled_dot_product_attention`` on a dequantized bf16 cache.
   Then every kernel's f32 instance against its plain version: the row
   quantization and the epilogue bit for bit, the weight-only product
   within ``F32_MATMUL_REL_LIMIT`` at ``F32_WEIGHT_ONLY`` (the prefill's
   down_proj, 9216 x 11008 x 4096, among them) with TF32 off, timed against
   the upcast + cuBLAS (its plain version), from a CUDA graph, with its plan
   and two bounds (three bf16 products at the bf16 peak, the one it is held
   to; f32 FMAs at the f32 peak), the attention and the decode's kernel
   within ``KV8_REL_LIMIT``.
4. Main path: builds MiniGPT-4 at full width (EVA ViT-g/14 at 448 px with 39
   layers, the 12-layer Q-Former, a 32-layer 4096-wide Vicuna-7B-shaped
   decoder) through ``MiniGPT4Model.from_config`` from the model block of
   ``configs/certify_configs/vqav2_certify_noise_0.5.yaml`` (int8 ViT and
   decoder kernels, W8A8 activations, int8 KV cache, cls-split attention)
   with seeded synthetic weights, and certifies one seeded synthetic
   448x448 image with n0 = 100, n = 1000, sigma = 0.5, mc_batch = 96, early
   exit, through ``agents.certify.certify_item`` with one chunk in flight
   (its per-stage clock synchronizes at every stage), after one warm-up
   certification of a single chunk each way. The kernels' launch counters
   are reset just before and read just after; each kernel of the path must
   have launched its launches per chunk times the chunks run (the decode's
   int8 kernels: per decode step times the steps launched), every other
   kernel never, and the plain cls query row not once (the cls-split kernel
   computes that row in its one launch). Prints per-stage seconds, peak
   device memory and the
   certify row, and checks the row. ``generate`` replays each decode step
   from the CUDA graph the warm-up's chunk captured, and each replay adds
   its captured launches to the counters, so the launch check holds as for
   eager steps (a capture's warm-up step is a step launched). Then one
   chunk's prefill, as the port
   runs it, with ``prefill_attention_kv8`` replaced by the sequence it
   took the place of, and with the W8A8 products as the pair the GEMM
   kernel replaced (``torch._int_mm``, then ``w8a8_epilogue``), in turns:
   device operations (192 fewer than the sequence; fewer than the pair)
   and eager time. Then times one decode step against
   converting the int8 decoder weights to bf16, the host's launch of one
   step from an idle card and behind a spin that holds the card (does the
   step fill the launch queue?), ``generate``'s captured step (embedding,
   decoder at the device slot, lm_head, choice, output column): its device
   ms a replay and the host's ms to launch a replay, beside the same step
   eager, and checks the outputs: the
   ViT through the kernels against the ViT through their plain versions on
   8 images (a cls stream of 8 rows: one partial row tile), finite
   projected image tokens, greedy tokens in range.
5. Profile: the warm-up's certification (one chunk each way) once more
   without and once under ``torch.profiler``; prints the device time summed
   by kernel group and the top kernels against the call's wall time, and the
   row-quant kernels' device time per call at the patch and the cls rows.
6. Attention forms: the same parameters under ``vit_attn_impl`` flash_custom
   and flash (configs parsed from the model block with the form changed).
   Their ViT tokens on 8 images agree with the flash_cls tower's within
   5e-2 relative (Frobenius); each of the three forms certifies the image
   over two chunks (n0 = n = 96) after a warm-up, with per-stage seconds
   and launch counts (flash_custom and flash: the flash kernel and the
   GELU kernel once a layer per chunk, no other kernel).
7. Entries: the noise kernel mode of ``noisy_tile``,
   ``cls_split_attention_scaled`` and ``multi_head_attention_kv8`` of a lone
   query row (one launch of the decode kernel, nothing written), which no
   certify path calls, each driven once through its entry point at the
   shapes above, launches counted; and the row-parallel dense of the
   tensor-parallel decoder (``row_parallel_dense``) at the prefill's
   down_proj through an NCCL group of one rank: one launch of the W8A8 GEMM
   kernel's int32 instance and one of ``w8a8_epilogue`` (the record's
   path), its output bit for bit the one-rank product's.
9.1-9.2. Look-ahead and early exit, on phase 4's model (run before phase
   8, which builds its own): ``certify_item`` with no clock at (window,
   early exit) (1, off), (4, off), (1, on), (4, on), (1, off) over four
   chunks (n0 = 96, n = 288, the shipped knobs otherwise), printing the
   wall and the decode steps launched a chunk and the peak memory; every
   draw's label and every row must be identical across the runs, and
   window 4's peak within phase 4's plus three noisy-image buffers. Then
   one chunk of the serial and one of the mixed pipeline dispatched, from
   the noise draw to the event behind the tokens' copy, under
   ``torch.cuda.set_sync_debug_mode("error")``: a host sync fails. Then
   the early exit firing: a tiny model whose weights chain each row's
   prompt to EOS at a different step decodes with the exit off and on under
   the same mode; the tokens must agree, and the exit must launch at least
   the steps until the last EOS and fewer than the full loop's.
8. Launcher: ``certifiedgpt_tpu_torch.launch.main`` runs ``certify`` on
   ``configs/certify_configs/vqav2_certify_noise_0.5.yaml`` and
   ``smoothing_predict`` on ``vqav2_predict_noise_0.5.yaml``, both
   unchanged (full width, seeded synthetic weights, ``dispatch_window``
   4 by default), over a written
   VQAv2-shaped set of two 640x480 JPEGs, with ``vqa_finetuned`` pointing at
   a written ``llama_proj`` checkpoint in the JAX package's ``.npz`` format
   (the environment variables the YAMLs read point at these files; the
   checkpoint paths of the model block at paths that do not exist). Checks
   the rows and summaries against the JAX package's keys, that every
   ``encode_img`` call read the checkpoint's projection bit for bit, and
   that each path kernel launched its launches per chunk (as in phase 4)
   times the chunks dispatched (an early stop leaves up to the window's
   chunks in flight); certifies again with the decoder's fused elementwise
   ops routed to the chains they replaced (phase 20) and the W8A8 product
   to the pair it replaced (phase 21): rows equal but for their seconds;
   prints the model build seconds, the seconds per
   image, the decode steps launched, the peak memory and the card's name
   and power limit, with the card's SM clock, power draw and temperature
   (``nvidia-smi`` each second) during phase 4's certification and each
   launcher run.
9.3. Continuous: ``launch.main`` runs ``certify`` on
   ``vqav2_certify_continuous.yaml`` unchanged (8 image slots, window 4)
   over 3 written images: 3 rows with the JAX package's continuous keys,
   each OTHER at phase 8's radius after all 1100 draws, a summary with
   ``continuous`` and ``images_per_hour``, ceil(3 x 1100 / 96) = 35 chunks
   dispatched with the path's launches each; prints seconds per image
   beside phase 8's serial figure, and the peak memory.
10. Eval: ``launch.main`` runs ``eval`` on
   ``configs/eval_configs/vqav2_eval_noise_0.5.yaml`` unchanged (batch 8,
   seq_len 320, early exit, window 2) over 10 written questions, two
   batches (the second padded from 2 rows): ``eval_results.json`` has the
   JAX package's summary keys and 10 predictions, each batch ran the
   path's launches; prints samples per second and the peak memory.

11. Training, with autograd on, over a written VQAv2-shaped set (96 train
   and 48 val 640x480 JPEGs; the model block's checkpoint paths where
   nothing exists). 11.1: on one full-width batch of
   ``configs/train_configs/vqav2_finetuning_noise_0.5_w8a8.yaml`` (48
   images packed 3 to a row, 16 rows x 256 tokens) the loss and the
   ``llama_proj`` gradient through the kernels against the same through
   their plain versions (limits ``TRAIN_LOSS_REL_LIMIT``,
   ``TRAIN_GRAD_REL_LIMIT``, and ``WEIGHT_ONLY_GRAD_REL_LIMIT`` with the
   decoder's activation quant off), with a control (the plain image tokens
   changed at random by as much); one decoder layer's straight-through
   backward against the layer with dequantized bf16 kernels; a batch whose
   last packed row is all padding gives finite values; a train step's
   launches (the decoder's six elementwise kernels, forward and backward,
   65 / 32 / 32 each way; ``quant_rows`` 32 in the decoder, the o_proj
   inputs), its synchronized stages, and its forward and backward each
   under a device trace: device seconds by kernel group and the largest
   kernels (``train_step_groups``; ``scripts/bench_torch_train_step.py``
   takes the same of other checkouts in turns). 11.2:
   ``launch.main(["train", ...])`` on that YAML and on
   ``vqav2_finetuning_noise_0.5.yaml`` (bf16 towers), each a copy with only
   ``max_epoch`` cut to ``TRAIN_EPOCHS``: every train step and val batch
   timed (synchronized) with its kernel launches (39 / 156 / 78 at W8A8, 39
   cls-split with the bf16 towers), finite losses, the checkpoints (the
   resume one with optimizer state), ``loss_history.json`` and the metric
   rows; prints seconds a step, samples and decoder tokens a second and
   the peak memory. 11.3: the predict YAML on phase 8's two images with
   ``vqa_finetuned`` the W8A8 run's ``_best`` checkpoint: every
   ``encode_img`` call reads the trained projection.
12. Checkpoints: 12.1 writes the four checkpoint files at full width from a
   seeded generator on the card, in the upstream formats, under a temporary
   directory (removed at the phase's end; the free disk space is printed
   first and must hold them): a Vicuna HF directory (``config.json``, two
   bf16 safetensors shards and ``model.safetensors.index.json``, written by
   ``write_safetensors``, and a BPE tokenizer trained here with its
   vocabulary padded to 32000 ids where ``transformers`` and ``tokenizers``
   import), ``eva_vit_g.pth`` (f16, BEiT naming, the position table at the
   224-px grid of 257 entries), the BLIP-2 ``.pth`` (``Qformer.bert.*``
   with the text branch, a root ``query_tokens``, keys of other modules)
   and the stage-2 ``.pth``. 12.2: ``launch.main`` certifies one written
   image with ``vqav2_certify_noise_0.5.yaml`` unchanged, ``VICUNA_7B``,
   ``EVA_VIT_G``, ``QFORMER_CKPT``, ``MINIGPT4_STAGE2`` at the files and
   ``VQA_FINETUNED`` empty; prints the seconds to write and to load each
   file, the model build, the peak device memory and host RSS of the load,
   the row and its launches a chunk; checks the first and last layer of
   every stack and the other sampled leaves against the written tensors
   transposed and cast (int8 stacks: ``quantize_kernel`` of them) bit for
   bit, that the row certifies, that every ``encode_img`` read the stage-2
   ``llama_proj``, and the path's launches per chunk.
13. Decode modes: ``launch.main`` runs ``vqav2_eval_noise_0.5.yaml`` on
   phase 10's ten questions with only its run block changed, once with
   ``num_beams: 3``, once sampling (``top_p`` 0.9), once with
   ``repetition_penalty`` 1.2 and ``min_length`` 2 (seconds, launches, peak
   memory, the JAX package's keys); then, on the full-width model,
   ``generate_beam`` at one beam gives greedy's tokens and sampling repeats
   with its seed and differs across seeds, and on phase 9.2's chain model
   ``min_length`` holds EOS back and ``generate`` with every knob and the
   early exit on is dispatched under ``set_sync_debug_mode("error")``.

14. Attack: 14.1 the three kernels of a victim caption at batch 1 against
   their plain versions within phase 3's limits (cls-split attention at
   [1, 16, 1024, 88] with its cls row, LN- and GELU-quant at 1024 and 1
   rows), their times and bounds at those shapes; 14.2 the five surrogates
   of ``configs/attack_configs/vqav2_attack.yaml`` (RN50, RN101, ViT-B/16,
   B/32, L/14) at full width, seeded on the card: one image's embedding
   and the loss gradient's signs against the CPU's, milliseconds a PGD step
   (forward + backward) on one image and on four, the resize's share, and
   the peak memory; 14.3 ``launch.main`` in
   ``attack`` mode on that YAML unchanged over two written images (100 PGD
   steps for each backbone, four sigmas, the full-width W8A8 victim from its
   seed) with ``CLIP_HF_DIR``/``CLIP_VIT_B32`` at a written full-width
   ViT-B/32 HF directory (``model.safetensors``, ``config.json``, a
   synthesized CLIP tokenizer) and ``CLIP_RN50`` at a written OpenAI-layout
   ``RN50.pt``: 40 rows within the 8/255 budget, the success-rate grid and
   the ANCOVA, loaded leaves equal to the written tensors, the CLIP text
   scorer, 39 / 156 / 78 launches a caption, every caption's projection the
   written checkpoint's; seconds per attacked image split into each
   backbone's PGD and the captions; then one caption through the kernels
   against their plain versions (image tokens within the attention's limit,
   the first step's logits against a control); 14.4 the RGF query stage
   (vit_b32, sigma 0.5, 2 queries, 1 iteration) over one image: its
   caption streams and launches.
15. Distributed and profiled: 15.1 phase 8's certify run again on the same
   written files (the shipped certify YAML at full width, ``max_images`` 1)
   with ``run.distributed`` (NCCL, world size 1: every chunk's token ids go
   through the batch group's all_gather) and ``enable_profile`` (image 0, a window of about one chunk),
   through ``python -m torch.distributed.run --standalone --nproc_per_node
   1`` running this script's one-rank worker (``--phase15-worker``, which
   calls ``launch.main`` between the launch counters): the row (label,
   radius, draws) equal to phase 8's first, its seconds beside phase 8's,
   NCCL in ``certified.log``, the trace's size and CUDA kernel events, the
   path kernels' launches a chunk; 15.2 one chunk of the main path with
   every stage (noise, ViT, Q-Former, prefill, decode, host labels) under
   its own ``torch.profiler`` context: device seconds by stage and kernel
   group, and the elementwise/copy seconds of ``encode_img``, the prefill
   and the decode; as the port runs it, then with the W8A8 product as the
   pair it replaced (phase 21), then with the chains the fused elementwise
   kernels replaced (phase 20).
16. Pipeline (run inside phase 11.1, on its full-width ``_w8a8`` model and
   packed batch of 48 images, 16 rows x 256 tokens; a one-process mesh
   whose pipe axis is 1): 16.1 ``parallel.pipeline.pipeline_minigpt4_loss``
   at 1, 2 and 4 microbatches, its loss and ``llama_proj`` gradient
   against ``minigpt4_loss`` on the same parameters within 11.1's limits
   (11.1's random-change control printed beside), 39 / 156 / 78 launches a step of the path
   kernels and none of the others, the schedule's hand-written backward
   once a step and the sequential decoder never; 16.2 a synchronized
   forward + backward at each count beside the sequential one (median of
   three, warmed by 16.1) with its peak device memory; 16.3 the sequential
   step and the 4-microbatch one under ``torch.profiler`` (summed kernel
   time, busy share, kernel launches), on ``[pipe]`` lines.
17. The twins of the JAX package's scripts, run as a user runs them (after
   phase 15, the earlier models freed): 17.1
   ``scripts/demo_chat_torch.py --config
   configs/certify_configs/vqav2_certify_noise_0.5.yaml`` (unchanged; its
   checkpoint variables where nothing exists, so seeded weights at full
   width) over a written 448x448 JPEG with two questions on its input, once
   answering and once with ``--stream``, each in a process of its own: exit
   0, two ``bot>`` lines each, turn 1's streamed text the answer's; beside
   them ``scripts/verify_attack_torch.py --synthetic``: exit 0, ``ok``, the
   grid of ``vit_tiny`` and ``rn_tiny``. 17.2: the same chat in this process
   on one model: a streamed turn's launches (a batch-1 chunk and its decode
   steps; the ``chat`` entry of ``cli_launches``), the model build, the
   seconds to turn 1's first piece and a piece after it, the peak memory,
   and turn 1 through ``Chat.answer`` giving the stream's token ids. 17.3:
   ``scripts/verify_attack_torch.py --images 1`` on
   ``configs/attack_configs/vqav2_attack.yaml`` over phase 14.3's written
   set with no CLIP checkpoint: exit 1, ``undischarged``, 0 checked, 20
   skipped, 0 failed, 20 rows; its seconds.
18. The f32 paths: 18.1 the full-width Vicuna-7B decoder at f32
   (``LlamaConfig(dtype=torch.float32, kv_quant=True)``, 32 layers, int8
   weight-only layer kernels, seeded on the card) prefills 96 tokens of 8
   rows into a 106-slot int8 cache through ``llama_apply`` and takes 10
   greedy decode steps, through the kernels and under their plain
   versions: every call's cache write bit for bit the plain quantization of
   its k and v; the prefill's logits within ``F32_DECODER_REL_LIMIT`` and
   ``F32_DECODER_LOGIT_FACTOR`` times a control (the plain run with its
   input embeddings changed at random by as much as the kernels change the
   first layer's q product); a prefill layer launches the tiled kernel once
   (the ``attention_kv8`` record's path) and the weight-only kernel seven
   times, no ``quant_rows``; a decode step ``PER_DECODE_STEP``; seconds of
   each run. 18.2 ``launch.main`` certifies two written images with the
   tiny model at f32 (int8 weight-only decoder kernels, int8 KV cache),
   once through the kernels and once under their plain versions: the rows
   (but their seconds) equal, each chunk's and decode step's launches.

19. The decode step replayed from a CUDA graph against the same step run
   eagerly (``generate(..., cuda_graph=False)``), on phase 4's model
   (after 9.2): (a) one certify chunk both ways, from a fresh capture:
   tokens equal and the last step's logits bit for bit (recorded by a
   wrapper of the token choice; otherwise within ``KV8_REL_LIMIT``, and
   printed), decode seconds both ways; (b) the early exit at full width:
   an EOS bias on the lm_head (a ``bias`` leaf, as the JAX ``bench.py``
   adds one), chosen from the eager run's logits so that every row stops
   by token ``EXIT_BY_TOKEN``: fewer than 9 steps launched, the tokens the
   eager full loop's; (c) two more chunks: one capture, none for the
   second; (d) the final norm's scale replaced by a copy: a new capture,
   the tokens the eager step's; (g) the peak memory over a graphed chunk
   beside phase 4's with the eager decode. (e) runs inside 14.2: for each surrogate,
   ``x_adv`` after ``ATTACK_TIMED_STEPS`` steps replayed bit for bit the
   eager loop's at one and four images, ms a step both ways; (f) inside
   17.2: turn 1 again replayed and eager, the same ids, seconds to the
   first piece and a piece both ways. Phase 3's decode kernel record also
   holds the kernel with its slot on the card (``slot_ms``,
   ``slot_graph_ms``: the output and cache bit for bit the int slot's).

21. The W8A8 product (inside phase 3, so ``--kernels`` runs it):
   ``w8a8_product``, one launch of ``csrc/w8a8_gemm.cu`` (wgmma int8 on
   TMA-fed shared memory, the rescale and the bias in registers), at every
   shipped shape (``W8A8_GEMM_SHAPES``: the ViT's four products on the
   patch and the cls streams, eval's 8-row cls stream, a caption's one
   row, the prefill's three, one shape off the tiles in M, K and N), bf16
   and f32 out, with and without a bias, on int8 operands of the full
   range: bit for bit ``_w8a8_epilogue_plain`` of the exact int32 sums
   (``torch._int_mm``'s, a yardstick the port never calls), and
   ``int8_accumulate`` (the kernel's int32 instance) equal to
   ``torch._int_mm``. Each shape is timed at the path's dtype and bias
   eager and alone (from a CUDA graph) beside its bound (operations at the
   int8 peak), its plain version, the pair it replaced (``torch._int_mm``
   and ``w8a8_epilogue``), ``torch._int_mm`` alone and cuBLAS bf16
   ``torch.mm``, with its launch plan; a chunk's ViT and prefill products
   are summed from the alone times.

23. The backward kernels of the decoder's fused elementwise ops (inside
   phase 3): ``add_rms_norm_grad``, ``rotary_grad`` and ``silu_mul_grad``
   (``csrc/elementwise.cu``) against their plain versions (autograd's
   backward of the plain chains, step by step) at a train step's shapes
   (16 packed rows x 256 tokens: [4096, 4096] with and without the
   stream's later gradient, q and k [16, 256, 32, 128] at restarting
   positions, [4096, 11008]), a batch-1 row and f32: the rotary's and the
   SiLU's bit for bit, the norm's within ``norm_grad_slack`` (its two row
   sums run in the kernel's order); each timed eager and alone (from a
   CUDA graph) beside its bound, its plain version and autograd's backward
   of the plain chain (what a train step ran before the kernels).

Prints one JSON line ``{"kernels": [...]}`` with every kernel's numbers (the
attention kernels' achieved TFLOP/s among them; ``attack_batch1``: phase
14.1's; ``cli_launches``: the launches in each launcher run of phases 8-15,
in phase 17.2's chat turn and in phase 18.2's tiny certify run),
and as its last line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernels`` stops after phase 3 (for work on one
kernel) and prints the kernel records instead of the two closing lines.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer operations: 64 INT32 lanes per SM (Hopper white paper),
# one operation each, against the 128 FP32 lanes that the f32 peak counts
# at two FLOPs per fused multiply-add
PEAK_INT32_OPS = PEAK_F32_FLOPS / 4

# f32 operations per element counted for the row-quant bounds (LayerNorm:
# two reductions, centre, scale, affine, round, absmax, scale, rint, pack;
# GELU: ~15 for the A-S erf plus the same quantization tail)
LN_QUANT_OPS_PER_ELEM = 12
GELU_QUANT_OPS_PER_ELEM = 25
# special-function units (log2, sqrt, cos): 16 an SM, one result a clock
# each, against the 128 FP32 lanes that the f32 peak counts at two FLOPs
PEAK_MUFU_OPS = PEAK_F32_FLOPS / 16

# the noise kernel per element. Integers: the counter is (image, pair, 0, 0),
# so Philox's rounds 1-2 and one product of round 3 depend on the image or
# the pair alone, once per launch each; a (pair, image) needs round 2's xor,
# round 3's product and two xors, and two products and two three-input xors
# in each of rounds 4-10, where one IMAD.WIDE.U32 gives both words of a
# product: 32 a pair of elements; each uniform is one shift-and-or (LEA.HI).
# f32: 1 - f1, the series near 1 (3), 2 - f1 and the log's scale, the select
# (2), f2 - 3/2 and its two scalings, r * c and x + sigma * g; special
# functions: lg2, sqrt and cos on their units
NOISE_INT_OPS_PER_ELEM = (1 + 3 + 7 * 4) / 2 + 2
NOISE_F32_OPS_PER_ELEM = 13
NOISE_MUFU_OPS_PER_ELEM = 3
# odd image sizes (elements) and copies, down to one element
NOISE_ODD_CASES = (((1,), 1), ((7,), 3), ((3, 3, 1), 3), ((5, 3, 3), 96), ((4097,), 96))

# main-path shapes at mc_batch 96 (EVA ViT-g/14 at 448 px)
MC_BATCH = 96
# batch_size of configs/eval_configs/vqav2_eval_noise_0.5.yaml
EVAL_BATCH = 8
# batch_size of the VQAv2 finetuning configs (configs/train_configs/)
TRAIN_BATCH = 48
VIT_TOKENS = 1024
VIT_SEQ = VIT_TOKENS + 1
VIT_WIDTH = 1408
VIT_HEADS = 16
VIT_HEAD_DIM = VIT_WIDTH // VIT_HEADS
VIT_MLP = 6144
VIT_DEPTH = 39
IMAGE_HWC = (448, 448, 3)
# the causal case of the flash kernel (the decoder-prefill form, in tests)
CAUSAL_SHAPE = (4, 333, VIT_HEADS, VIT_HEAD_DIM)
# the decoder of the certify model (Vicuna-7B widths)
LLAMA_DEPTH = 32
LLAMA_WIDTH = 4096
LLAMA_MLP = 11008
LLAMA_HEADS = 32
LLAMA_HEAD_DIM = LLAMA_WIDTH // LLAMA_HEADS
# seq_len of configs/eval_configs/vqav2_eval_noise_0.5.yaml
EVAL_SEQ = 320

# model block of configs/certify_configs/vqav2_certify_noise_0.5.yaml; its
# checkpoint paths are left out: the weights are seeded synthetic ones
CERTIFY_MODEL_BLOCK = {
    "arch": "minigpt4",
    "vit_attn_impl": "flash_cls",
    "quantize_llama": True,
    "quantize_vit": True,
    "act_quant": True,
    "kv_quant": True,
    "model_size": "full",
    "image_size": 448,
    "num_query_token": 32,
}
# the ViT's attention forms that the flash kernel serves, beside flash_cls
FLASH_FORMS = ("flash_custom", "flash")

RUN_CFG = {  # run block of configs/certify_configs/vqav2_certify_noise_0.5.yaml
    "noise_level": 0.5,
    "certify_n0": 100,
    "certify_n": 1000,
    "certify_alpha": 0.001,
    "mc_batch": MC_BATCH,
    "max_new_tokens": 10,
    "early_exit": True,
    "early_abstain": True,
    "early_stop_radius": 1.0,
    "seq_len": 96,
    "seed": 42,
}
# rows of the ViT's patch stream and of the decoder's prefill a chunk, and
# the KV cache's positions
VIT_ROWS = MC_BATCH * VIT_TOKENS
PREFILL_ROWS = MC_BATCH * RUN_CFG["seq_len"]
F32_ROWS = EVAL_BATCH * RUN_CFG["seq_len"]  # phase 18's f32 decoder prefill
CACHE_LEN = RUN_CFG["seq_len"] + RUN_CFG["max_new_tokens"]
# phase 4 reads per-stage seconds with a clock that synchronizes the card at
# every stage: one chunk in flight
CLOCKED_RUN_CFG = dict(RUN_CFG, dispatch_window=1)
# one chunk for selection and one for estimation: warm-up and profile
TWO_CHUNK_RUN_CFG = dict(RUN_CFG, certify_n0=MC_BATCH, certify_n=MC_BATCH,
                         early_abstain=False, early_stop_radius=None)
# phase 9.1: the shipped knobs with a budget of four chunks (one selection,
# three estimation: at n = 288 no early stop can fire on these draws)
LOOKAHEAD_RUN_CFG = dict(RUN_CFG, certify_n0=MC_BATCH, certify_n=3 * MC_BATCH)
# (dispatch_window, early_exit) of phase 9.1's runs, in their order; the
# last repeats the first to show drift
LOOKAHEAD_RUNS = ((1, False), (4, False), (1, True), (4, True), (1, False))
# phase 9.2's early exit that fires: a tiny model whose decoder sends each
# prompt's last token along its chain to EOS (2), as in
# tests/test_torch_generate_gpu.py: (last prompt token, the tokens after it)
EXIT_CHAINS = ((20, ()), (10, (11, 12)), (30, (31, 32, 33, 34)), (40, (41,)))
EXIT_STEPS = 24
EXIT_ROWS = (0, 1, 2, 3, 1)  # the chain of each row of the batch
# phase 4: the card is held by a spin of this length while the host launches
# one decode step, to see whether the step's launches fill the launch queue
SPIN_MS = 500.0
QUESTION = "<Img><ImageHere></Img> [vqa] Based on the image, what animal is this?"
GT_ANSWERS = ["cat", "cat", "cat", "dog", "cat", "cat", "kitten", "cat", "cat", "cat"]

# kernel-name substrings of each profile group, first match wins
PROFILE_GROUPS = (
    ("attention kernel", ("attention_kernel",)),
    ("row-quant kernels", ("ln_quant_kernel", "gelu_quant_kernel", "quant_rows_kernel")),
    ("W8A8 GEMM kernel", ("w8a8_gemm_kernel",)),
    ("W8A8 epilogue kernel", ("w8a8_epilogue_kernel",)),
    ("weight-only int8 kernel", ("int8_weight_matmul_kernel",)),
    ("decoder elementwise kernels", ("add_rms_norm_kernel", "rotary_kernel", "silu_mul_kernel")),
    ("decoder elementwise backward kernels", ("add_rms_norm_grad_kernel", "rotary_grad_kernel",
                                              "silu_mul_grad_kernel")),
    ("straight-through gradient kernel", ("w8_grad_gemm_kernel",)),
    ("training attention kernels", ("train_attention_fwd_kernel", "train_attention_dq_kernel",
                                    "train_attention_dkv_kernel")),
    ("int8-KV attention kernel", ("attention_kv8_kernel", "kv8_prefill_kernel",
                                  "kv8_decode_kernel")),
    ("GEMMs (int8, bf16, f32)", ("gemm", "nvjet", "gemv", "cutlass", "sm90_xmma", "ampere")),
    ("reductions", ("reduce_kernel",)),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn`` replayed from one CUDA graph of
    ``iters`` calls: the card's time alone, where back-to-back eager calls
    (``cuda_ms``) can be held to the host's pace of launching them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(torch, graph.replay, iters=3, warmup=1) / iters
    del graph
    return ms


class CardSampler:
    """``nvidia-smi``'s SM clock, power draw and temperature about once a
    second while the ``with`` block runs, from a thread that the block's end
    stops and joins."""

    QUERY = "--query-gpu=clocks.sm,power.draw,temperature.gpu"

    def __enter__(self):
        import threading

        self.samples = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._sample, daemon=True)
        self.thread.start()
        return self

    def _sample(self):
        while not self.stop.wait(1.0):
            out = subprocess.run(["nvidia-smi", self.QUERY, "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout
            try:
                self.samples.append([float(v) for v in out.splitlines()[0].split(",")])
            except (IndexError, ValueError):
                pass  # a read the card did not answer: no sample

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=60)

    def summary(self) -> str:
        if not self.samples:
            return "no nvidia-smi samples"
        clock, power, temp = zip(*self.samples)
        return (f"SM clock mean {sum(clock) / len(clock):.0f} MHz (min {min(clock):.0f}), "
                f"power draw mean {sum(power) / len(power):.1f} W, temperature max "
                f"{max(temp):.0f} C over {len(clock)} samples")


def bound_ms(bytes_moved: float, ops: float, peak_ops: float, *more_ops):
    """The larger of the bytes' time and each operation type's time
    (``more_ops``: further (ops, peak) pairs, for a kernel that mixes
    types on separate units)."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = max(o / p * 1e3 for o, p in ((ops, peak_ops), *more_ops))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 1 and 2
# ----------------------------------------------------------------------
def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    return card


def ptxas_resources(log_text: str) -> dict:
    """Each entry function's registers and spill bytes from ``ptxas -v``'s
    output: {mangled name: (registers, spill store bytes, spill load bytes)}."""
    out, name, spills = {}, None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spills)
            name, spills = None, (0, 0)
    return out


# the kernels whose registers and spills get a [build] line of their own and
# go into their `kernels` records (name part of the mangled entry -> record)
PTXAS_KERNELS = (("w8a8_gemm_kernel", "w8a8_gemm"),
                 ("int8_weight_matmul_kernel", "int8_weight_matmul"),
                 ("kv8_prefill_kernel", "attention_kv8_prefill"),
                 ("attention_kv8_kernel", "attention_kv8"),
                 ("kv8_decode_kernel", "attention_kv8_decode"),
                 ("add_rms_norm_kernel", "add_rms_norm"), ("rotary_kernel", "rotary"),
                 ("silu_mul_kernel", "silu_mul"), ("rotary_grad_kernel", "rotary_grad"),
                 ("w8_grad_gemm_kernel", "w8_grad_gemm"),
                 ("train_attention_fwd_kernel", "train_attention_fwd"),
                 ("train_attention_dq_kernel", "train_attention_dq"),
                 ("train_attention_dkv_kernel", "train_attention_dkv"))


def phase_build():
    """Build the kernels, log ptxas' summary; returns {record name:
    {mangled kernel: {registers, spill_stores, spill_loads}}} for
    ``PTXAS_KERNELS``."""
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    t0 = time.perf_counter()
    build = cuda_kernels.build()
    log(
        f"[build] {build.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.seconds:.2f} s)"
    )
    for line in build.log.splitlines():
        if line.startswith("==") or any(w in line for w in ("Used", "spill", "arning", "wgmma")):
            log(f"[build] {line.strip()}")
    igmma = wgmma_counts()
    resources = {}
    for fn, (regs, stores, loads) in sorted(ptxas_resources(build.log).items()):
        part = next((p for p in PTXAS_KERNELS if p[0] in fn), None)
        if part is None:
            continue
        resources.setdefault(part[1], {})[fn] = {"registers": regs, "spill_stores": stores,
                                                  "spill_loads": loads}
        extra = ""
        if fn in igmma:
            resources[part[1]][fn]["igmma"] = igmma[fn]
            extra = f", {igmma[fn]} IGMMA instructions in its SASS"
        log(f"[build] {part[1]}: {fn}: {regs} registers, {stores} bytes spill stores, "
            f"{loads} bytes spill loads{extra}")
    return resources


def wgmma_counts() -> dict:
    """IGMMA instructions (the int8 wgmma) in the SASS of each instance of
    the W8A8 GEMM kernel (``cuobjdump -sass``, ``sass_count.py``): each must
    have some, or the kernel never reaches Hopper's int8 tensor-core path."""
    import sass_count
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    text = sass_count.sass_of(cuda_kernels.build().path)
    found = {fn: ops.get("IGMMA", 0)
             for fn, ops in sass_count.opcode_counts(text, "w8a8_gemm_kernel").items()}
    if not found or not all(found.values()):
        fail(f"the W8A8 GEMM kernel's instances hold no IGMMA instruction: {found}")
    return found


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------
def compare_codes(torch, a, b):
    """(elements off by one step, their share, the largest step, the largest
    relative scale difference, the largest dequantized difference) of two
    row quantizations (codes, scales)."""
    (qa, sa), (qb, sb) = a, b
    dq = (qa.int() - qb.int()).abs()
    off = int((dq > 0).sum())
    rel = float(((sa - sb).abs() / sb.abs()).max())
    err = float((qa.float() * sa - qb.float() * sb).abs().max())
    return off, off / max(dq.numel(), 1), int(dq.max()), rel, err


def check_row_quant(torch, name, kernel, plains, shapes, ops_per_elem, make_args):
    """Compare an int8 row-quant kernel with its plain versions at each shape
    (row counts of the main path, 1 and 4097; one row of zeros in each input
    of more than one row) on N(0, 3^2) inputs, each plain version with its
    limits ``(plain, max step, max share off, max scale rel)``; time the
    first (the patch stream's) shape on N(0, 1) and N(0, 3^2) inputs, and
    the second (the cls stream's). ``ms`` is the N(0, 1) time: the main
    path's activations are of that size."""
    record = {}
    for m, k in shapes:
        args = make_args(m, k, 3.0)
        if m > 1:
            args[0][m // 2].zero_()
        out = kernel(*args)
        torch.cuda.synchronize()
        for plain, step, share, srel in plains:
            off, frac, worst, rel, err = compare_codes(torch, out, plain(*args))
            log(f"[kernel] {name} [{m}, {k}] vs {plain.__name__}: int8 off-by-one {off}/{m * k} "
                f"({frac:.2e}), max code diff {worst}, scale rel err {rel:.2e}, "
                f"max |dequant diff| {err:.3e}")
            if worst > step or frac > share or not rel <= srel:
                fail(f"{name} disagrees with {plain.__name__} at [{m}, {k}]")
            record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
        if (m, k) == shapes[0]:
            for std in (1.0, 3.0):
                a = args if std == 3.0 else make_args(m, k, std)
                record[f"ms_std{std:g}"] = cuda_ms(torch, lambda: kernel(*a), iters=20)
            record["ms"] = record["ms_std1"]
            record["plain_ms"] = cuda_ms(torch, lambda: plains[0][0](*args), iters=5, warmup=1)
            x = args[0]
            moved = x.numel() * x.element_size() + m * k + 4 * m
            moved += sum(a.numel() * a.element_size() for a in args[1:3] if hasattr(a, "numel"))
            bms, by = bound_ms(moved, ops_per_elem * m * k, PEAK_F32_FLOPS)
            record.update(bound_ms=bms, bound_by=by, library_ms=None)
            log(f"[kernel] {name} [{m}, {k}]: {record['ms_std1']:.4f} ms on N(0,1), "
                f"{record['ms_std3']:.4f} ms on N(0,3^2), plain {record['plain_ms']:.3f} ms, "
                f"bound {bms:.4f} ms ({by})")
        elif (m, k) == shapes[1]:
            record["ms_cls"] = cuda_ms(torch, lambda: kernel(*args), iters=20)
            log(f"[kernel] {name} [{m}, {k}]: {record['ms_cls']:.4f} ms")
        del args, out
        torch.cuda.empty_cache()
    return record


def check_cls_split(torch, device, b=MC_BATCH):
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    h, n, d = VIT_HEADS, VIT_TOKENS, VIT_WIDTH // VIT_HEADS
    g = torch.Generator(device=device).manual_seed(1)
    prem = (d ** -0.5) * FA.CLS_SPLIT_Q_PREMUL_LOG2E
    # operands as the main path makes them: strided views of the fused qkv
    # output [B, S, 3, H, D] (q pre-scaled)
    scale3 = torch.tensor([prem, 1.0, 1.0], device=device)[None, None, :, None, None]

    def qkv(s):
        y = torch.randn((b, s, 3, h, d), generator=g, device=device) * scale3
        y = y.to(torch.bfloat16)
        return [y[:, :, i].transpose(1, 2) for i in range(3)]

    qp, kp, vp = qkv(n)
    qc, kc, vc = qkv(1)
    args = (qp, kp, vp, qc, kc, vc)
    out_c, out_p = FA.cls_split_attention_parts(*args)
    ref_c, ref_p = FA._cls_split_attention_plain(*args)
    row = FA._cls_query_row(qc, kp, vp, kc, vc)  # the plain version of the kernel's cls row
    torch.cuda.synchronize()
    err_c = max(max_err(out_c, ref_c), max_err(out_c, row))
    err = max(max_err(out_p, ref_p), err_c)
    rel = max(rel_err(out_p, ref_p), rel_err(out_c, ref_c), rel_err(out_c, row))
    # both against f32 attention on the same (bf16) inputs, for scale
    ex_c, ex_p = FA._cls_split_attention_plain(*(a.float() for a in args))
    err_k = float((out_p.float() - ex_p).abs().max())
    err_p = float((ref_p.float() - ex_p).abs().max())
    log(
        f"[kernel] cls_split_attention [{b}, {h}, {n}, {d}]: max abs err {err:.3e} "
        f"(the cls row {err_c:.3e}), relative (Frobenius) {rel:.3e} "
        f"(max |out| {float(ex_p.abs().max()):.3f}; vs f32 attention: kernel "
        f"{err_k:.3e}, plain {err_p:.3e})"
    )
    del ex_c, ex_p, row
    if not math.isfinite(err) or err > 2e-2 or not rel < ATTN_REL_LIMIT:
        fail("cls_split_attention disagrees with its plain version")
    # ms: the wrapper's one launch (N patch rows and the cls row); plain_ms and
    # library_ms compute the same N + 1 rows
    ms = cuda_ms(torch, lambda: FA.cls_split_attention_parts(*args), iters=10 if b > 1 else 100)
    plain_ms = cuda_ms(torch, lambda: FA._cls_split_attention_plain(*args), iters=3, warmup=1)
    q = torch.cat([qc, qp], dim=2)
    k = torch.cat([kc, kp], dim=2)
    v = torch.cat([vc, vp], dim=2)
    library_ms = cuda_ms(
        torch,
        lambda: F.scaled_dot_product_attention(q, k, v, scale=math.log(2.0)),
        iters=10,
    )
    ops = 4.0 * b * h * (n + 1) * (n + 1) * d  # N + 1 query rows over N + 1 keys
    moved = 2.0 * 4 * b * h * (n + 1) * d  # q, k, v with their cls rows, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    tflops = ops / ms / 1e9
    log(f"[kernel] cls_split_attention batch {b}: one launch with the cls row {ms:.4f} ms "
        f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del args, out_c, out_p, ref_c, ref_p, q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "tflops": tflops}


def fused_bshd(torch, g, device, b, s, h, d):
    """q, k, v as ``[B, S, H, D]`` views of one fused qkv product
    ``[B, S, 3 H D]`` (row stride 3 H D), as the ViT's flash_custom block
    makes them; ``.transpose(1, 2)`` gives the flash block's ``[B, H, S, D]``
    views of the same product."""
    y = torch.randn((b, s, 3 * h * d), generator=g, device=device).to(torch.bfloat16)
    return [t.reshape(b, s, h, d) for t in y.split(h * d, dim=-1)]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    """Relative Frobenius error of ``a`` against ``b``: catches a fault of one
    key tile that a max-abs limit, loose against outputs of ~0.05, lets by."""
    return float((a.float() - b.float()).norm() / b.float().norm())


# limit on the relative Frobenius error of the attention kernels against
# their plain versions (bf16 outputs and P: ~4e-3 measured on the H100)
ATTN_REL_LIMIT = 1e-2


def check_flash(torch, device):
    """The flash kernel at the ViT's shape in both layouts (flash_custom's
    [B, S, H, D] views, flash's [B, H, S, D] views) and causal at
    CAUSAL_SHAPE, against the plain version; timed against the plain
    version and ``scaled_dot_product_attention`` on the same views."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    b, s, h, d = MC_BATCH, VIT_SEQ, VIT_HEADS, VIT_HEAD_DIM
    scale = d ** -0.5
    g = torch.Generator(device=device).manual_seed(2)
    q, k, v = fused_bshd(torch, g, device, b, s, h, d)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    out = FA.flash_attention(q, k, v)
    out_h = FA.builtin_flash_attention_bhsd(qh, kh, vh, d)
    ref = FA._flash_attention_plain(q, k, v, False, scale)
    torch.cuda.synchronize()
    err = max(max_err(out, ref), max_err(out_h.transpose(1, 2), ref))
    rel = max(rel_err(out, ref), rel_err(out_h.transpose(1, 2), ref))
    exact = FA._flash_attention_plain(q.float(), k.float(), v.float(), False, scale)
    err_k, err_p = max_err(out, exact), max_err(ref, exact)
    log(f"[kernel] flash_attention [{b}, {s}, {h}, {d}]: max abs err {err:.3e}, relative "
        f"(Frobenius) {rel:.3e} over both layouts (max |out| {float(exact.abs().max()):.3f}; "
        f"vs f32 attention: kernel "
        f"{err_k:.3e}, plain {err_p:.3e})")
    del out, out_h, exact
    torch.cuda.empty_cache()

    qc, kc, vc = fused_bshd(torch, g, device, *CAUSAL_SHAPE)
    out_c = FA.flash_attention(qc, kc, vc, causal=True)
    ref_c = FA._flash_attention_plain(qc, kc, vc, True, scale)
    err_c = max_err(out_c, ref_c)
    rel_c = rel_err(out_c, ref_c)
    # the first query sees only the first key
    err_first = max_err(out_c[:, 0], vc[:, 0])
    causal_ms = cuda_ms(torch, lambda: FA.flash_attention(qc, kc, vc, causal=True), iters=20)
    causal_plain_ms = cuda_ms(torch, lambda: FA._flash_attention_plain(qc, kc, vc, True, scale),
                              iters=5, warmup=1)
    log(f"[kernel] flash_attention causal {list(CAUSAL_SHAPE)}: max abs err {err_c:.3e}, "
        f"relative (Frobenius) {rel_c:.3e} (first row vs v[0]: {err_first:.3e}); "
        f"kernel {causal_ms:.3f} ms, "
        f"plain {causal_plain_ms:.3f} ms")
    for name, e in (("flash_attention", err), ("flash_attention causal", err_c),
                    ("flash_attention causal row 0", err_first)):
        if not math.isfinite(e) or e > 2e-2:
            fail(f"{name} disagrees with its plain version ({e:.3e})")
    for name, e in (("flash_attention", rel), ("flash_attention causal", rel_c)):
        if not e < ATTN_REL_LIMIT:
            fail(f"{name} disagrees with its plain version (relative {e:.3e})")

    ms = cuda_ms(torch, lambda: FA.flash_attention(q, k, v), iters=10)
    ms_bhsd = cuda_ms(torch, lambda: FA.builtin_flash_attention_bhsd(qh, kh, vh, d), iters=10)
    plain_ms = cuda_ms(torch, lambda: FA._flash_attention_plain(q, k, v, False, scale),
                       iters=3, warmup=1)
    library_ms = cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), iters=10)
    ops = 4.0 * b * h * s * s * d
    moved = 2.0 * 4 * b * s * h * d  # q, k, v, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    tflops = ops / ms / 1e9
    log(f"[kernel] flash_attention: kernel {ms:.3f} ms on [B, S, H, D] views (flash_custom, "
        f"{tflops:.1f} TFLOP/s), "
        f"{ms_bhsd:.3f} ms on [B, H, S, D] views (flash), plain {plain_ms:.3f} ms, "
        f"scaled_dot_product_attention {library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del q, k, v, qh, kh, vh, ref, qc, kc, vc, out_c, ref_c
    torch.cuda.empty_cache()
    return {"max_abs_err": max(err, err_c), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "ms_bhsd": ms_bhsd, "causal_ms": causal_ms, "tflops": tflops}


def check_cls_split_scaled(torch, device):
    """The explicit-scale cls-split form on ``[B, H, 1025, D]`` tensors with
    cls at index 0 (the patch operands are views one row in)."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import flash_attention as FA

    b, h, s, d = MC_BATCH, VIT_HEADS, VIT_SEQ, VIT_HEAD_DIM
    scale = d ** -0.5
    g = torch.Generator(device=device).manual_seed(4)
    q, k, v = (torch.randn((b, h, s, d), generator=g, device=device).to(torch.bfloat16)
               for _ in range(3))
    out = FA.cls_split_attention_scaled(q, k, v, d)
    ref = FA._cls_split_attention_scaled_plain(q, k, v, scale)
    scale_log2 = scale * FA.CLS_SPLIT_Q_PREMUL_LOG2E
    row = FA._cls_query_row(q[:, :, :1], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1],
                            scale_log2)
    torch.cuda.synchronize()
    err_c = max(max_err(out[:, :, :1], ref[:, :, :1]), max_err(out[:, :, :1], row))
    err = max(max_err(out, ref), err_c)
    rel = max(rel_err(out, ref), rel_err(out[:, :, :1], ref[:, :, :1]),
              rel_err(out[:, :, :1], row))
    log(f"[kernel] cls_split_attention_scaled [{b}, {h}, {s}, {d}]: max abs err {err:.3e} "
        f"(the cls row {err_c:.3e}), relative (Frobenius) {rel:.3e} "
        f"(max |out| {float(ref.float().abs().max()):.3f})")
    if not math.isfinite(err) or err > 2e-2 or not rel < ATTN_REL_LIMIT:
        fail("cls_split_attention_scaled disagrees with its plain version")
    # ms: the wrapper's one launch, all 1 + N rows
    ms = cuda_ms(torch, lambda: FA.cls_split_attention_scaled(q, k, v, d), iters=10)
    plain_ms = cuda_ms(torch, lambda: FA._cls_split_attention_scaled_plain(q, k, v, scale),
                       iters=3, warmup=1)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                         iters=10)
    ops = 4.0 * b * h * s * s * d  # N + 1 query rows over N + 1 keys
    moved = 2.0 * 4 * b * h * s * d  # q, k, v, out
    bms, by = bound_ms(moved, ops, PEAK_BF16_FLOPS)
    tflops = ops / ms / 1e9
    log(f"[kernel] cls_split_attention_scaled: one launch with the cls row {ms:.3f} ms "
        f"({tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, scaled_dot_product_attention "
        f"{library_ms:.3f} ms, bound {bms:.3f} ms ({by})")
    del q, k, v, out, ref, row
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "tflops": tflops}


def check_noise(torch, device):
    """The noise kernel at mc_batch copies of a 448 px image, sigma 0.5, and
    at odd sizes down to one element: its values agree with the plain
    version's on the same seed words within 1e-5 (the plain version's exact
    log, sqrt and cos against the kernel's domain-limited ones; other Philox
    words would give other normals, off by O(sigma)), (out - x) / sigma has
    mean 0 and std 1 within 0.01, and sigma = 0 returns the clean tile bit
    for bit. Also prints the kernel's SASS instructions an element (one trip
    of its image loop) and the time they take at 128 a clock an SM at the
    card's highest SM clock: the issue rate, beside the bound but not one."""
    import sass_count
    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import noise as N

    n, sigma = MC_BATCH, 0.5
    g = torch.Generator(device=device).manual_seed(3)
    sig = torch.tensor(sigma, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    odd_err = 0.0
    for shape, copies in NOISE_ODD_CASES:
        xs = torch.randn(shape, generator=g, device=device)
        out = N.noisy_tile(xs, copies, sigma, gen.manual_seed(8), use_kernel=True)
        ref = N._noisy_tile_kernel_plain(xs, copies, sig, N._seed_words(gen.manual_seed(8), device))
        e = max_err(out, ref)
        if out.shape != ref.shape or not math.isfinite(e) or e > 1e-5:
            fail(f"the noise kernel disagrees with its plain version at {copies} x {list(shape)} "
                 f"({e:.3e})")
        odd_err = max(odd_err, e)
    x = torch.randn(IMAGE_HWC, generator=g, device=device)
    out = N.noisy_tile(x, n, sigma, gen.manual_seed(7), use_kernel=True)
    seed = N._seed_words(gen.manual_seed(7), device)
    ref = N._noisy_tile_kernel_plain(x, n, sig, seed)
    err = max_err(out, ref)
    unequal = int((out != ref).sum())
    resid = (out - x) / sigma
    mean, std = float(resid.mean()), float(resid.std())
    zero_tile = N.noisy_tile(x, n, 0.0, gen, use_kernel=True)
    clean = bool(torch.equal(zero_tile, x.expand_as(zero_tile)))
    log(f"[kernel] noisy_tile kernel [{n}, {', '.join(map(str, IMAGE_HWC))}] sigma {sigma}: "
        f"max abs err against the plain version {err:.3e}, so max |g - g_plain| "
        f"{err / sigma:.3e} ({unequal} of {out.numel()} values not bit-identical); odd sizes "
        f"{', '.join(f'{c} x {list(s)}' for s, c in NOISE_ODD_CASES)}: max abs err "
        f"{odd_err:.3e}; noise mean {mean:.2e}, std {std:.5f}; sigma 0 returns the clean "
        f"tile: {clean}")
    if not math.isfinite(err) or err > 1e-5:
        fail("the noise kernel disagrees with its plain version")
    if abs(mean) > 0.01 or abs(std - 1.0) > 0.01 or not clean:
        fail("the noise kernel's noise is not N(0, sigma^2) or sigma = 0 is not exact")
    del out, ref, resid, zero_tile
    torch.cuda.empty_cache()

    xc = x.contiguous()
    ms = cuda_ms(torch, lambda: N._launch_noise(xc, n, sig, seed), iters=20)
    plain_ms = cuda_ms(torch, lambda: N._noisy_tile_kernel_plain(x, n, sig, seed),
                       iters=3, warmup=1)
    # the live path: torch.randn (Philox in PyTorch's own kernel) + add
    library_ms = cuda_ms(torch, lambda: N.noisy_tile(x, n, sigma, gen), iters=20)
    elems = n * x.numel()
    moved = 4.0 * (x.numel() + elems)
    bms, by = bound_ms(moved, NOISE_INT_OPS_PER_ELEM * elems, PEAK_INT32_OPS,
                       (NOISE_F32_OPS_PER_ELEM * elems, PEAK_F32_FLOPS),
                       (NOISE_MUFU_OPS_PER_ELEM * elems, PEAK_MUFU_OPS))
    trip, per_elem = sass_count.noise_trip(cuda_kernels.build().path)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = sass_count.max_sm_clock_mhz()
    issue_ms = sass_count.issue_ms(per_elem, elems, sms, clock)
    log(f"[kernel] noisy_tile kernel: {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"torch.randn + add {library_ms:.3f} ms, bound {bms:.4f} ms ({by}; bytes alone "
        f"{moved / PEAK_BYTES_PER_S * 1e3:.4f} ms, integers "
        f"{NOISE_INT_OPS_PER_ELEM * elems / PEAK_INT32_OPS * 1e3:.4f} ms, special functions "
        f"{NOISE_MUFU_OPS_PER_ELEM * elems / PEAK_MUFU_OPS * 1e3:.4f} ms); SASS "
        f"{per_elem:.2f} instructions an element (one trip of the image loop: "
        f"{json.dumps(trip)}), issue rate {issue_ms:.4f} ms at the highest SM clock "
        f"{clock:.0f} MHz on {sms} SMs (not a bound)")
    return {"max_abs_err": max(err, odd_err), "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": library_ms, "max_abs_g_err": err / sigma,
            "sass_per_elem": per_elem}


# limits of the row-quant kernels against their plain versions: (largest
# code step, share of elements off, scale relative difference). The kernels
# repeat the plain versions' roundings (the LayerNorm's sums in its order, the
# GELU's A-S erf), so only the approximate reciprocal and exponential of the
# erf move a bf16 rounding, rarely; against the exact erf, one bf16 step
# anywhere in a row may move its scale.
ROW_QUANT_TIGHT = (1, 1e-4, 1e-6)
ROW_QUANT_EXACT_ERF = (1, 1e-3, 1e-2)


def row_quant_args(torch, device, seed: int):
    """Makers of the row-quant kernels' arguments ``(m, k, std)``: bf16
    N(0, std^2) rows, and the LayerNorm's scale and bias."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=g, device=device) * std).to(torch.bfloat16)

    def ln_args(m, k, std):
        scale = (1.0 + 0.1 * torch.randn(k, generator=g, device=device)).to(torch.bfloat16)
        bias = (0.1 * torch.randn(k, generator=g, device=device)).to(torch.bfloat16)
        return [normal((m, k), std), scale, bias, 1e-6]

    def gelu_args(m, k, std):
        return [normal((m, k), std)]

    return ln_args, gelu_args


def bits_unequal(torch, a, b) -> int:
    """Elements of two tensors of one dtype whose bits differ."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return int((a.view(view) != b.view(view)).sum())


# quantize_rows' kernel at the ViT's proj input (patch and cls streams), the
# prefill's product inputs, the KV cache's rows (a prefill's and a decode
# step's), and at 1 and 8 rows (a caption; eval's batch)
QUANT_ROWS_SHAPES = ((VIT_ROWS, VIT_WIDTH), (MC_BATCH, VIT_WIDTH), (PREFILL_ROWS, LLAMA_WIDTH),
                     (PREFILL_ROWS, LLAMA_MLP), (PREFILL_ROWS * LLAMA_HEADS, LLAMA_HEAD_DIM),
                     (MC_BATCH * LLAMA_HEADS, LLAMA_HEAD_DIM), (1, VIT_WIDTH),
                     (EVAL_BATCH, LLAMA_WIDTH))
# f32 operations an element counted for quantize_rows' bound: |x|, max, the
# product with 1 / xs, the rounding, the clip and the pack
QUANT_ROWS_OPS_PER_ELEM = 6


def check_quant_rows(torch, device):
    """quantize_rows' kernel against its plain version at ``QUANT_ROWS_SHAPES``
    on N(0, 3^2) rows with a row of zeros: codes and scales bit for bit.
    Each shape timed against the plain version (the call the kernel
    replaces: the same two-step form)."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(6)
    record = {"max_abs_err": 0.0, "shapes": {}}
    for m, k in QUANT_ROWS_SHAPES:
        x = (torch.randn((m, k), generator=g, device=device) * 3).to(torch.bfloat16)
        if m > 1:
            x[m // 2].zero_()
        q, s = Q.quantize_rows(x)
        pq, ps = Q._quantize_rows_plain(x)
        torch.cuda.synchronize()
        off = bits_unequal(torch, q, pq) + bits_unequal(torch, s, ps)
        err = compare_codes(torch, (q, s), (pq, ps))[-1]
        ms = cuda_ms(torch, lambda: Q.quantize_rows(x), iters=20)
        g_ms = graph_ms(torch, lambda: Q.quantize_rows(x))
        plain_ms = cuda_ms(torch, lambda: Q._quantize_rows_plain(x), iters=5, warmup=1)
        bms, by = bound_ms(3.0 * m * k + 4 * m, QUANT_ROWS_OPS_PER_ELEM * m * k, PEAK_F32_FLOPS)
        log(f"[kernel] quant_rows [{m}, {k}]: {off} codes and scales not bit-identical to the "
            f"plain version; {ms:.4f} ms ({g_ms:.4f} from a CUDA graph), plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms ({by})")
        if off:
            fail(f"quant_rows disagrees with its plain version at [{m}, {k}]")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["shapes"][f"{m}x{k}"] = {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                                        "bound_ms": bms}
        if (m, k) == QUANT_ROWS_SHAPES[0]:
            record.update(ms=ms, plain_ms=plain_ms, replaced_ms=plain_ms, bound_ms=bms,
                          bound_by=by, library_ms=None)
        del x, q, s, pq, ps
        torch.cuda.empty_cache()
    return record


# the W8A8 epilogue at the ViT's products (qkv, fc1, proj and fc2 on the
# patch stream, qkv on the cls stream; with their biases), the prefill's
# (q/k/v/o and down at 4096 columns, gate/up at 11008; no bias), and at 1
# and 8 rows: (rows, columns, bias)
EPILOGUE_SHAPES = ((VIT_ROWS, 3 * VIT_WIDTH, True), (VIT_ROWS, VIT_MLP, True),
                   (VIT_ROWS, VIT_WIDTH, True), (MC_BATCH, 3 * VIT_WIDTH, True),
                   (PREFILL_ROWS, LLAMA_WIDTH, False), (PREFILL_ROWS, LLAMA_MLP, False),
                   (1, 3 * VIT_WIDTH, True), (EVAL_BATCH, VIT_MLP, True))
# f32 operations an element counted for the epilogue's bound: the convert,
# two products and the bias add
EPILOGUE_OPS_PER_ELEM = 4


def check_w8a8_epilogue(torch, device):
    """The W8A8 epilogue against its plain chain (the call it replaces) at
    ``EPILOGUE_SHAPES``, bit for bit, from int32 accumulators of int8
    products' size; each shape timed."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(5)
    record = {"max_abs_err": 0.0, "shapes": {}}
    for m, n, with_bias in EPILOGUE_SHAPES:
        acc = torch.randint(-2 ** 23, 2 ** 23, (m, n), generator=g, device=device,
                            dtype=torch.int32)
        xs = torch.rand((m, 1), generator=g, device=device) * 1e-2 + 1e-3
        ws = torch.rand(n, generator=g, device=device) * 1e-4
        bias = ((torch.randn(n, generator=g, device=device) * 0.1).to(torch.bfloat16)
                if with_bias else None)
        out = Q.w8a8_epilogue(acc, xs, ws, bias)
        ref = Q._w8a8_epilogue_plain(acc, xs, ws, bias, torch.bfloat16)
        torch.cuda.synchronize()
        off = bits_unequal(torch, out, ref)
        ms = cuda_ms(torch, lambda: Q.w8a8_epilogue(acc, xs, ws, bias), iters=10)
        g_ms = graph_ms(torch, lambda: Q.w8a8_epilogue(acc, xs, ws, bias), iters=10)
        plain_ms = cuda_ms(torch, lambda: Q._w8a8_epilogue_plain(acc, xs, ws, bias,
                                                                 torch.bfloat16),
                           iters=3, warmup=1)
        moved = 6.0 * m * n + 4 * m + 4 * n + (2 * n if with_bias else 0)
        bms, by = bound_ms(moved, EPILOGUE_OPS_PER_ELEM * m * n, PEAK_F32_FLOPS)
        log(f"[kernel] w8a8_epilogue [{m}, {n}]{' + bias' if with_bias else ''}: {off} outputs "
            f"not bit-identical to the plain chain; {ms:.4f} ms ({g_ms:.4f} from a CUDA graph), "
            f"plain chain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        if off:
            fail(f"w8a8_epilogue disagrees with its plain chain at [{m}, {n}]")
        record["max_abs_err"] = max(record["max_abs_err"], max_err(out, ref))
        record["shapes"][f"{m}x{n}"] = {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                                        "bound_ms": bms}
        if (m, n, with_bias) == EPILOGUE_SHAPES[0]:
            record.update(ms=ms, plain_ms=plain_ms, replaced_ms=plain_ms, bound_ms=bms,
                          bound_by=by, library_ms=None)
        del acc, out, ref
        torch.cuda.empty_cache()
    return record


# ----------------------------------------------------------------------
# phase 21: the W8A8 product as one kernel (csrc/w8a8_gemm.cu)
# ----------------------------------------------------------------------
# every shipped shape of the product (label, rows, K, N, the path's bias):
# the ViT's four on the patch stream and on the cls stream of a chunk,
# eval's 8-row cls stream, a caption's single cls row, the prefill's three,
# and rows, K and N all off the tiles
W8A8_GEMM_SHAPES = (
    ("ViT qkv", VIT_ROWS, VIT_WIDTH, 3 * VIT_WIDTH, True),
    ("ViT proj", VIT_ROWS, VIT_WIDTH, VIT_WIDTH, True),
    ("ViT fc1", VIT_ROWS, VIT_WIDTH, VIT_MLP, True),
    ("ViT fc2", VIT_ROWS, VIT_MLP, VIT_WIDTH, True),
    ("cls qkv", MC_BATCH, VIT_WIDTH, 3 * VIT_WIDTH, True),
    ("cls proj", MC_BATCH, VIT_WIDTH, VIT_WIDTH, True),
    ("cls fc1", MC_BATCH, VIT_WIDTH, VIT_MLP, True),
    ("cls fc2", MC_BATCH, VIT_MLP, VIT_WIDTH, True),
    ("eval cls qkv", EVAL_BATCH, VIT_WIDTH, 3 * VIT_WIDTH, True),
    ("caption cls fc1", 1, VIT_WIDTH, VIT_MLP, True),
    ("prefill q/k/v/o", PREFILL_ROWS, LLAMA_WIDTH, LLAMA_WIDTH, False),
    ("prefill gate/up", PREFILL_ROWS, LLAMA_WIDTH, LLAMA_MLP, False),
    ("prefill down", PREFILL_ROWS, LLAMA_MLP, LLAMA_WIDTH, False),
    ("ragged", 1000, 4112, 200, True),
    # the edges of the persistent, clustered and split launches: tiles
    # several times the blocks with an odd count of row tiles (a cluster's
    # partner past the edge), K off the step, a whole split row tile
    ("odd row tiles", 25 * 128 - 7, VIT_WIDTH, 3 * VIT_WIDTH, True),
    ("K off the step", 2000, 1424, 1408, True),
    ("128 rows fc2", 128, VIT_MLP, VIT_WIDTH, True),
    ("128 rows qkv", 128, VIT_WIDTH, 3 * VIT_WIDTH, True),
)
# products of one layer (label: count) in a certify chunk's ViT (patch and
# cls streams) and prefill
VIT_LAYER_PRODUCTS = {"ViT qkv": 1, "ViT proj": 1, "ViT fc1": 1, "ViT fc2": 1, "cls qkv": 1,
                      "cls proj": 1, "cls fc1": 1, "cls fc2": 1}
PREFILL_LAYER_PRODUCTS = {"prefill q/k/v/o": 4, "prefill gate/up": 2, "prefill down": 1}
# csrc/w8a8_gemm.cu's tile rows and K step (bytes)
W8A8_BLOCK_M, W8A8_BLOCK_K = 128, 128
# the fields of cgpt_w8a8_gemm_plan's answer: "tiles" counts each split's,
# "blocks" are those launched (persistent), "cluster" the blocks that share
# B by multicast
W8A8_GEMM_PLAN = ("tile_n", "stages", "row_tiles", "channel_tiles", "tiles", "blocks",
                  "smem_bytes", "cluster", "k_splits", "k_steps_a_split", "epilogue")
# cgpt_w8a8_gemm_plan's epilogue codes
W8A8_EPILOGUES = {1: "staged apart from the ring, TMA store under the next tile"}


def w8a8_gemm_plan(m: int, k: int, n: int) -> dict:
    """The W8A8 GEMM launcher's plan for an [m, k] x [k, n] product, with
    the K splits that ``w8a8_product`` asks for."""
    import ctypes

    import torch

    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import quantization as Q

    splits = Q.w8a8_splits(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    plan = (ctypes.c_int * len(W8A8_GEMM_PLAN))()
    cuda_kernels.check(cuda_kernels.build().lib.cgpt_w8a8_gemm_plan(m, n, k, splits, plan),
                       "w8a8_gemm plan")
    out = dict(zip(W8A8_GEMM_PLAN, plan))
    out["epilogue"] = W8A8_EPILOGUES[out["epilogue"]]
    return out


def int_mm(torch, xq, kq):
    """``torch._int_mm`` of int8 rows and a column-major int8 kernel, rows
    zero-padded to 24 where there are fewer (it takes M > 16): the library's
    exact int32 product, a yardstick here and never called by the port."""
    import torch.nn.functional as F

    m = xq.shape[0]
    if m < 24:
        xq = F.pad(xq, (0, 0, 0, 24 - m))
    return torch._int_mm(xq, kq)[:m]


def phase_w8a8_gemm(torch, device):
    """Phase 21: ``w8a8_product`` (one launch of ``csrc/w8a8_gemm.cu``) at
    ``W8A8_GEMM_SHAPES`` on int8 operands of the full range, bf16 and f32
    out, with and without a bias, bit for bit ``_w8a8_epilogue_plain`` of the
    exact int32 sums (``torch._int_mm``'s); ``int8_accumulate`` (the
    kernel's int32 instance) equal to ``torch._int_mm``. At the path's
    dtype and bias each shape is timed eager and alone (replayed from a
    CUDA graph) beside its bound, its plain version, the pair it replaced
    (``torch._int_mm`` and ``w8a8_epilogue``, alone), ``torch._int_mm``
    alone (the library figure) and cuBLAS bf16 ``torch.mm`` at the same
    shape, with the launch plan; and a chunk's ViT and prefill products
    are summed from the alone times. Returns the kernel's record."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(21)
    record = {"max_abs_err": 0.0, "shapes": {}}
    for label, m, k, n, path_bias in W8A8_GEMM_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
        kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=device,
                                                dtype=torch.int8))
        xs = torch.rand((m, 1), generator=g, device=device) * 1e-2 + 1e-3
        ws = torch.rand(n, generator=g, device=device) * 1e-4
        acc = int_mm(torch, xq, kq)
        sums_off = int((Q.int8_accumulate(xq, kq) != acc).sum())
        off, biases = {}, {}
        for dtype in (torch.bfloat16, torch.float32):
            for with_bias in (False, True):
                bias = ((torch.randn(n, generator=g, device=device) * 0.1).to(dtype)
                        if with_bias else None)
                got = Q.w8a8_product(xq, xs, kq, ws, bias, dtype)
                want = Q._w8a8_epilogue_plain(acc, xs, ws, bias, dtype)
                torch.cuda.synchronize()
                name = f"{str(dtype)[6:]}{' + bias' if with_bias else ''}"
                off[name] = bits_unequal(torch, got, want)
                if got.dtype != dtype or got.shape != (m, n):
                    fail(f"w8a8_product gave {got.dtype} {tuple(got.shape)} at {label}")
                record["max_abs_err"] = max(record["max_abs_err"], max_err(got, want))
                biases[(dtype, with_bias)] = bias
                del got, want
        bias = biases[(torch.bfloat16, path_bias)]
        big = m * n >= 10 ** 8
        t = {"ms": cuda_ms(torch, lambda: Q.w8a8_product(xq, xs, kq, ws, bias), iters=10),
             "graph_ms": graph_ms(torch, lambda: Q.w8a8_product(xq, xs, kq, ws, bias)),
             "plain_ms": cuda_ms(torch, lambda: Q._w8a8_product_plain(xq, xs, kq, ws, bias,
                                                                      torch.bfloat16),
                                 iters=2 if big else 5, warmup=1),
             "replaced_eager_ms": cuda_ms(
                 torch, lambda: Q.w8a8_epilogue(int_mm(torch, xq, kq), xs, ws, bias), iters=10),
             "replaced_ms": graph_ms(
                 torch, lambda: Q.w8a8_epilogue(int_mm(torch, xq, kq), xs, ws, bias)),
             "library_ms": graph_ms(torch, lambda: int_mm(torch, xq, kq))}
        a16, w16 = xq.to(torch.bfloat16), kq.to(torch.bfloat16)
        t["bf16_mm_ms"] = graph_ms(torch, lambda: torch.mm(a16, w16))
        del a16, w16
        moved = 1.0 * m * k + k * n + 2 * m * n + 4 * m + 4 * n + (2 * n if path_bias else 0)
        t["bound_ms"], t["bound_by"] = bound_ms(moved, 2.0 * m * k * n, PEAK_INT8_OPS)
        plan = w8a8_gemm_plan(m, k, n)
        # the L2 reads the plan implies (each block's A tile and its share of
        # the cluster's B tile a K step) over the alone time
        l2 = plan["tiles"] * plan["k_steps_a_split"] * W8A8_BLOCK_K * (
            W8A8_BLOCK_M + plan["tile_n"] / plan["cluster"])
        t.update(plan=plan, bits_off=off, sums_off=sums_off, share=t["bound_ms"] / t["graph_ms"],
                 l2_tb_s=l2 / t["graph_ms"] / 1e9)
        log(f"[w8a8] 21 {label} [{m}, {k}] x [{k}, {n}]: outputs not bit-identical to the "
            f"plain rescale of the exact sums {json.dumps(off)}, int32 sums off {sums_off}; "
            f"{t['ms']:.4f} ms eager, {t['graph_ms']:.4f} ms alone ("
            f"{100 * t['bound_ms'] / t['graph_ms']:.0f} % of the bound {t['bound_ms']:.4f} ms, "
            f"{t['bound_by']}), plain {t['plain_ms']:.4f} ms, replaced _int_mm + w8a8_epilogue "
            f"{t['replaced_ms']:.4f} ms alone ({t['replaced_eager_ms']:.4f} eager), _int_mm "
            f"{t['library_ms']:.4f} ms alone, cuBLAS bf16 mm {t['bf16_mm_ms']:.4f} ms alone; "
            f"L2 reads {t['l2_tb_s']:.2f} TB/s; plan {json.dumps(t['plan'])}")
        if sums_off or any(off.values()):
            fail(f"w8a8_product disagrees with the plain rescale of the exact sums at {label}")
        if label.startswith("ViT") and not t["plan"]["blocks"] < t["plan"]["tiles"]:
            fail(f"w8a8_product at {label} is not persistent: {t['plan']}")
        record["shapes"][label] = t
        if not record.get("ms"):
            record.update({key: t[key] for key in ("ms", "graph_ms", "plain_ms", "replaced_ms",
                                                   "library_ms", "bound_ms", "bound_by")})
        del xq, kq, acc, biases, bias
        torch.cuda.empty_cache()
    chunk = {}
    for stage, layers, products in (("vit", VIT_DEPTH, VIT_LAYER_PRODUCTS),
                                    ("prefill", LLAMA_DEPTH, PREFILL_LAYER_PRODUCTS)):
        for key in ("graph_ms", "replaced_ms", "library_ms", "bound_ms"):
            chunk[f"{stage}_{key}"] = layers * sum(
                c * record["shapes"][label][key] for label, c in products.items())
    record["chunk"] = chunk
    log(f"[w8a8] 21 a certify chunk's products from the alone times: ViT "
        f"{chunk['vit_graph_ms']:.2f} ms (the replaced pair {chunk['vit_replaced_ms']:.2f}, "
        f"_int_mm {chunk['vit_library_ms']:.2f}, bound {chunk['vit_bound_ms']:.2f}), prefill "
        f"{chunk['prefill_graph_ms']:.2f} ms (the pair {chunk['prefill_replaced_ms']:.2f}, "
        f"_int_mm {chunk['prefill_library_ms']:.2f}, bound {chunk['prefill_bound_ms']:.2f}); "
        f"phase 21 took {time.perf_counter() - t0:.1f} s")
    return record


# limit on the relative Frobenius error of the weight-only int8 kernel against
# its plain version: both sum the same exact products in f32, in another
# order, so only a few bf16 roundings of the output move, one step (2^-8) each
INT8_MATMUL_REL_LIMIT = 2e-3
# the decoder's weight-only products (K, N, products a layer): q/k/v/o,
# gate/up, down; at the certify decode's rows, eval's, a caption's and a
# prefill without activation quant
WEIGHT_ONLY_SHAPES = ((LLAMA_WIDTH, LLAMA_WIDTH, 4), (LLAMA_WIDTH, LLAMA_MLP, 2),
                      (LLAMA_MLP, LLAMA_WIDTH, 1))
WEIGHT_ONLY_ROWS = (MC_BATCH, EVAL_BATCH, 1, PREFILL_ROWS)
# the fields of cgpt_int8_weight_matmul_plan's answer
WEIGHT_ONLY_PLAN = ("rows", "row_tiles", "channel_tiles", "splits", "k_per_split",
                    "resident_blocks", "stages")


def weight_only_plan(m: int, k: int, n: int, f32: bool = False) -> dict:
    """The weight-only launcher's plan for an [m, k] x [k, n] product (bf16
    x, or f32 with ``f32``): rows a block, row and channel tiles, K splits
    (the cluster size), K values a split, blocks the card holds at once in
    such clusters, ring stages."""
    import ctypes

    from certifiedgpt_tpu_torch.ops import cuda_kernels

    plan = (ctypes.c_int * len(WEIGHT_ONLY_PLAN))()
    cuda_kernels.check(
        cuda_kernels.build().lib.cgpt_int8_weight_matmul_plan(m, n, k, int(f32), plan),
        "int8_weight_matmul plan")
    return dict(zip(WEIGHT_ONLY_PLAN, plan))


def check_int8_weight(torch, device):
    """The weight-only int8 kernel against its plain version (f32 sums of
    the same products) at ``WEIGHT_ONLY_SHAPES`` x ``WEIGHT_ONLY_ROWS``
    within ``INT8_MATMUL_REL_LIMIT``; each timed against the plain version,
    the call it replaces (``torch.matmul`` on a bf16 copy of the int8
    kernel made in the call) and cuBLAS on a bf16 weight converted before.
    The record's times are a decode layer's seven products at the certify
    decode's 96 rows."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(7)
    record = {"max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": {}}
    layer = dict.fromkeys(("ms", "plain_ms", "replaced_ms", "library_ms", "bound_ms", "graph_ms",
                           "library_graph_ms"), 0.0)
    for k, n, per_layer in WEIGHT_ONLY_SHAPES:
        kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=device,
                                                dtype=torch.int8))
        scale = torch.rand(n, generator=g, device=device) * 1e-3
        w16 = kq.to(torch.bfloat16)
        for m in WEIGHT_ONLY_ROWS:
            x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
            out = Q.int8_weight_forward(x, kq, scale)
            ref = Q._int8_weight_forward_plain(x, kq, scale)
            torch.cuda.synchronize()
            rel, err = rel_err(out, ref), max_err(out, ref)
            iters = 3 if m == PREFILL_ROWS else 20
            t = {"ms": cuda_ms(torch, lambda: Q.int8_weight_forward(x, kq, scale), iters),
                 "plain_ms": cuda_ms(torch, lambda: Q._int8_weight_forward_plain(x, kq, scale),
                                     iters),
                 "replaced_ms": cuda_ms(torch, lambda: (torch.matmul(x, kq.to(torch.bfloat16))
                                                        .float() * scale).to(torch.bfloat16),
                                        iters),
                 "library_ms": cuda_ms(torch, lambda: torch.matmul(x, w16), iters),
                 "graph_ms": graph_ms(torch, lambda: Q.int8_weight_forward(x, kq, scale)),
                 "library_graph_ms": graph_ms(torch, lambda: torch.matmul(x, w16))}
            t["bound_ms"], by = bound_ms(1.0 * k * n + 2 * m * k + 2 * m * n + 4 * n,
                                         2.0 * m * k * n, PEAK_BF16_FLOPS)
            t["plan"] = weight_only_plan(m, k, n)
            log(f"[kernel] int8_weight_matmul [{m}, {k}] x [{k}, {n}]: relative error "
                f"(Frobenius) {rel:.3e}, max abs {err:.3e}; {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bf16 copy + matmul (replaced) {t['replaced_ms']:.4f} ms, "
                f"cuBLAS on a bf16 weight {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({by}); from a CUDA graph (the card alone): kernel {t['graph_ms']:.4f} ms "
                f"({1e-6 * k * n / t['graph_ms']:.1f} GB/s of weights), cuBLAS "
                f"{t['library_graph_ms']:.4f} ms; plan {json.dumps(t['plan'])}")
            if not (math.isfinite(rel) and rel < INT8_MATMUL_REL_LIMIT):
                fail(f"int8_weight_matmul disagrees with its plain version at [{m}, {k}] x "
                     f"[{k}, {n}] (relative {rel:.3e})")
            record["max_abs_err"] = max(record["max_abs_err"], err)
            record["max_rel_err"] = max(record["max_rel_err"], rel)
            record["shapes"][f"{m}x{k}x{n}"] = t
            if m == MC_BATCH:
                for key in layer:
                    layer[key] += per_layer * t[key]
                record.setdefault("bound_by", by)
            del x, out, ref
        del kq, w16
        torch.cuda.empty_cache()
    record.update(layer)
    record["sass_i2f"] = check_no_i2f()
    log(f"[kernel] int8_weight_matmul: a decode layer's seven products at {MC_BATCH} rows "
        f"{layer['ms']:.4f} ms, plain {layer['plain_ms']:.4f} ms, replaced "
        f"{layer['replaced_ms']:.4f} ms, cuBLAS on bf16 weights {layer['library_ms']:.4f} ms, "
        f"bound {layer['bound_ms']:.4f} ms; from CUDA graphs: kernel {layer['graph_ms']:.4f} ms, "
        f"cuBLAS {layer['library_graph_ms']:.4f} ms")
    return record


def check_no_i2f() -> dict:
    """I2F/I2FP instructions in each instance of the weight-only kernel
    (bf16 and f32) and in the decode's and the prefill's int8-KV kernels
    (``cuobjdump -sass``): their conversion is byte permutes and an f32
    subtraction (the prefill's codes a magic add), so there must be none.
    The tiled int8-KV kernel's count is recorded beside: its conversion is
    the same, its index arithmetic divides by run-time sizes."""
    import sass_count
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    text = sass_count.sass_of(cuda_kernels.build().path)
    found = {}
    for part in ("int8_weight_matmul_kernelILi", "kv8_prefill_kernel", "kv8_decode_kernel",
                 "attention_kv8_kernel"):
        counts = sass_count.opcode_counts(text, part)
        if not counts:
            fail(f"no SASS function matching {part!r} in the built library")
        for fn, ops in counts.items():
            found[fn] = sum(n for op, n in ops.items() if op.startswith("I2F"))
            log(f"[kernel] SASS {fn}: {sum(ops.values())} instructions, {found[fn]} I2F/I2FP")
    bad = {fn: n for fn, n in found.items() if n and "attention_kv8_kernel" not in fn}
    if bad:
        fail(f"the weight-only or an int8-KV kernel converts with I2F: {bad}")
    return found


# the entry multi_head_attention_kv8 over the int8 cache: the certify and
# eval prefills (bf16 rows: the prefill's kernel with no rows to write),
# eval's and a caption's decode rows and a lone row at the certify batch (the
# decode kernel with nothing to write), grouped-query heads: (batch, query
# rows, heads, kv heads, cached positions, offset of the first query)
KV8_CASES = (("eval prefill", EVAL_BATCH, EVAL_SEQ, LLAMA_HEADS, LLAMA_HEADS, EVAL_SEQ + 10, 0),
             ("prefill", MC_BATCH, RUN_CFG["seq_len"], LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, 0),
             ("eval decode", EVAL_BATCH, 1, LLAMA_HEADS, LLAMA_HEADS, EVAL_SEQ + 10, EVAL_SEQ),
             ("caption decode", 1, 1, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, CACHE_LEN - 2),
             ("lone row", MC_BATCH, 1, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, CACHE_LEN - 2),
             ("grouped", 4, 5, LLAMA_HEADS, 8, CACHE_LEN, 3))


def kv8_case(torch, device, g, b, sq, h, h_kv, t, offset):
    """q and a quantized cache with the decoder's mask (query i at position
    offset + i sees slot j <= offset + i that its row keeps; row 0 left-padded
    by two slots, the last batch row fully masked)."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    d = LLAMA_HEAD_DIM
    q = torch.randn((b, sq, h, d), generator=g, device=device).to(torch.bfloat16)
    kq, ks = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=device)
                             .to(torch.bfloat16))
    vq, vs = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=device)
                             .to(torch.bfloat16))
    return (q, kq, ks, vq, vs, decoder_mask(torch, device, b, sq, t, offset))


def decoder_mask(torch, device, b, sq, t, offset):
    """[B, 1, Sq, T]: query i at slot offset + i sees the slots up to its
    own; row 0 left-padded by two slots, the last batch row fully masked."""
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    q_pos = offset + torch.arange(sq, device=device)[:, None]
    return (torch.arange(t, device=device)[None, :] <= q_pos)[None, None] & valid[:, None, None]


def dequantized(torch, cache, rep):
    """The cache's k and v dequantized to bf16 [B, H, T, Dh] (kv heads
    repeated ``rep`` times): the operands of ``scaled_dot_product_attention``,
    made before the timing."""
    kd = (cache["k"].float() * cache["k_scale"]).to(torch.bfloat16)
    vd = (cache["v"].float() * cache["v_scale"]).to(torch.bfloat16)
    return (kd.repeat_interleave(rep, 2).transpose(1, 2),
            vd.repeat_interleave(rep, 2).transpose(1, 2))


# limit on the relative Frobenius error of the int8-KV attention kernels
# against their plain versions: both round p to bf16 and multiply exactly, so
# only the order of the f32 sums and the exponential's last bits differ
# (1.6e-5 measured, H100 80GB HBM3, 700.00 W); skipping the bf16 rounding
# of p gives 2.6e-3 (the plain version so changed, on the CPU)
KV8_REL_LIMIT = 5e-4


def kernel_of(counters_before):
    """The int8-KV kernel that ran since ``counters_before`` (the three
    wrappers' launches), by the counter that moved: "tiled", "prefill" or
    "decode"; None unless exactly one moved by one."""
    from certifiedgpt_tpu_torch.ops import attention as A

    moved = [name for name, fn, n in zip(("tiled", "prefill", "decode"),
                                          (A.multi_head_attention_kv8, A.prefill_attention_kv8,
                                           A.decode_attention_kv8), counters_before)
             if fn.launches != n]
    return moved[0] if len(moved) == 1 and sum(
        fn.launches - n for fn, n in zip((A.multi_head_attention_kv8, A.prefill_attention_kv8,
                                          A.decode_attention_kv8), counters_before)) == 1 else None


def kv8_counters():
    from certifiedgpt_tpu_torch.ops import attention as A

    return (A.multi_head_attention_kv8.launches, A.prefill_attention_kv8.launches,
            A.decode_attention_kv8.launches)


def check_attention_kv8(torch, device):
    """The entry ``multi_head_attention_kv8`` against its plain version at
    ``KV8_CASES`` within ``KV8_REL_LIMIT`` (relative Frobenius) and 2e-2
    absolute, a fully masked row giving zeros, each call one launch of the
    kernel ``kv8_kernel`` names (several bf16 rows the prefill's kernel, a
    lone row the decode kernel, both with nothing to write), the cache bit
    for bit as it was. Returns the lone bf16 row's times at the certify
    batch (the decode kernel), eager and from a CUDA graph, against its
    plain version, the tiled kernel on the same row and
    ``scaled_dot_product_attention`` on the cache dequantized to bf16
    beforehand."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import attention as A

    g = torch.Generator(device=device).manual_seed(8)
    lone = {}
    for name, b, sq, h, h_kv, t, offset in KV8_CASES:
        args = kv8_case(torch, device, g, b, sq, h, h_kv, t, offset)
        q, kq, ks, vq, vs, mask = args
        kept = [c.clone() for c in (kq, ks, vq, vs)]
        before = kv8_counters()
        out = A.multi_head_attention_kv8(*args)
        ref = A._multi_head_attention_kv8_plain(*args)
        torch.cuda.synchronize()
        kernel, want = kernel_of(before), A.kv8_kernel(q.dtype, sq, LLAMA_HEAD_DIM, h // h_kv,
                                                        False)
        rel, err = rel_err(out, ref), max_err(out, ref)
        zeros = b == 1 or not bool(out[-1].any())
        same = all(bits_unequal(torch, a, c) == 0 for a, c in zip((kq, ks, vq, vs), kept))
        log(f"[kernel] attention_kv8 {name} q [{b}, {sq}, {h}, {LLAMA_HEAD_DIM}] over "
            f"{t} cached positions of {h_kv} heads ({kernel} kernel): relative error "
            f"(Frobenius) {rel:.3e}, max abs {err:.3e}; fully masked row zeros: {zeros}; "
            f"cache unchanged: {same}")
        if not (rel < KV8_REL_LIMIT and err <= 2e-2) or not zeros or not same:
            fail(f"attention_kv8 disagrees with its plain version or wrote the cache ({name})")
        if kernel != want:
            fail(f"attention_kv8 {name}: {sq} query rows ran the {kernel} kernel, not {want}")
        if name == "lone row":
            kd, vd = dequantized(torch, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs},
                                 h // h_kv)
            qh = q.transpose(1, 2)
            ks3, vs3 = ks[..., 0], vs[..., 0]
            tiled = lambda: A._launch_tiled_kv8(q, None, None, kq, vq, ks3, vs3, t, mask,  # noqa: E731
                                                LLAMA_HEAD_DIM ** -0.5)
            tm = {"ms": cuda_ms(torch, lambda: A.multi_head_attention_kv8(*args), iters=20),
                  "graph_ms": graph_ms(torch, lambda: A.multi_head_attention_kv8(*args)),
                  "plain_ms": cuda_ms(torch, lambda: A._multi_head_attention_kv8_plain(*args),
                                      iters=5, warmup=1),
                  "tiled_ms": cuda_ms(torch, tiled, iters=20),
                  "tiled_graph_ms": graph_ms(torch, tiled),
                  "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                      qh, kd, vd, attn_mask=mask, scale=LLAMA_HEAD_DIM ** -0.5), iters=20)}
            rows_kept = float(mask.expand(b, 1, sq, t).sum())
            moved = (2.0 * 2 * b * sq * h * LLAMA_HEAD_DIM + 2.0 * b * t * h_kv * LLAMA_HEAD_DIM
                     + 8.0 * b * t * h_kv + b * sq * t)
            tm["bound_ms"], tm["bound_by"] = bound_ms(moved, 4.0 * LLAMA_HEAD_DIM * h * rows_kept,
                                                      PEAK_BF16_FLOPS)
            tm["rel_err"], tm["max_abs_err"] = rel, err
            log(f"[kernel] attention_kv8 {name} (the decode kernel, nothing written): "
                f"{tm['ms']:.4f} ms ({tm['graph_ms']:.4f} from a CUDA graph), plain "
                f"{tm['plain_ms']:.4f} ms, the tiled kernel on the same row {tm['tiled_ms']:.4f} "
                f"ms ({tm['tiled_graph_ms']:.4f} from a graph), scaled_dot_product_attention on "
                f"a dequantized bf16 cache {tm['library_ms']:.4f} ms, bound "
                f"{tm['bound_ms']:.4f} ms ({tm['bound_by']})")
            lone = tm
            del kd, vd, qh
        del args, q, kq, ks, vq, vs, mask, out, ref, kept
        torch.cuda.empty_cache()
    return lone


# the f32 prefill (the tiled kernel with its cache write): the certify
# prefill, eval's and a 2048-slot cache at an offset past 0: (batch, new
# rows, heads, kv heads, cached positions, the first new row's slot)
KV8_TILED_CASES = (
    ("certify f32 prefill", MC_BATCH, RUN_CFG["seq_len"], LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, 0),
    ("eval f32 prefill", EVAL_BATCH, EVAL_SEQ, LLAMA_HEADS, LLAMA_HEADS, EVAL_SEQ + 10, 0),
    ("long f32 cache", EVAL_BATCH, RUN_CFG["seq_len"], LLAMA_HEADS, LLAMA_HEADS, 2048, 1900))


def check_attention_kv8_tiled(torch, device):
    """The tiled kernel (``csrc/attention_kv8.cu``) at ``KV8_TILED_CASES``
    through ``prefill_attention_kv8`` on f32: one launch, the cache's codes
    and scales bit for bit its plain version's, the output within
    ``KV8_REL_LIMIT`` and 2e-2 absolute, a fully masked row zeros; each
    timed eager and from a CUDA graph against its plain version, the
    launches it replaces (``quantize_rows``' kernel on k and v, the four
    slice writes and the attention, here the tiled kernel with nothing to
    write) and ``scaled_dot_product_attention`` on the cache dequantized to
    f32 beforehand, with its launch plan and two bounds: the three bf16
    products of its design at the bf16 peak (the one it is held to) and
    the f32 FMAs of the plain version's arithmetic at the f32 peak."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(18)
    record = {"max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": {}}
    d = LLAMA_HEAD_DIM
    for name, b, s, h, h_kv, t, offset in KV8_TILED_CASES:
        _, _, _, cache, offset, mask = kv8_prefill_case(torch, device, g, b, s, h, h_kv, t,
                                                        offset)
        # f32 values that are not bf16 values: every term of the split counts
        q, k, v = (torch.randn((b, s, n, d), generator=g, device=device) for n in (h, h_kv, h_kv))
        mine, theirs = copy_cache(cache), copy_cache(cache)
        before = kv8_counters()
        out = A.prefill_attention_kv8(q, k, v, mine, offset, mask)
        kernel = kernel_of(before)
        ref = A._prefill_attention_kv8_plain(q, k, v, theirs, offset, mask)
        torch.cuda.synchronize()
        off, rel, err = cache_bits_unequal(torch, mine, theirs), rel_err(out, ref), \
            max_err(out, ref)
        zeros = not bool(out[-1].any())
        log(f"[kernel] attention_kv8 {name} (f32 q [{b}, {s}, {h}, {d}], {s} new rows at "
            f"{offset} into {t} slots; the {kernel} kernel): cache {off} values not bit for "
            f"bit, relative error (Frobenius) {rel:.3e}, max abs {err:.3e}; fully masked row "
            f"zeros: {zeros}")
        if kernel != "tiled" or off or not (rel < KV8_REL_LIMIT and err <= 2e-2) or not zeros:
            fail(f"attention_kv8 {name}: the tiled kernel disagrees with its plain version")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["max_rel_err"] = max(record["max_rel_err"], rel)

        def replaced(q=q, k=k, v=v, c=copy_cache(cache), offset=offset, mask=mask):
            kq, ks = Q.quantize_rows(k)
            vq, vs = Q.quantize_rows(v)
            at = slice(offset, offset + k.shape[1])
            c["k"][:, at], c["v"][:, at], c["k_scale"][:, at], c["v_scale"][:, at] = \
                kq, vq, ks, vs
            return A.multi_head_attention_kv8(q, c["k"], c["k_scale"], c["v"], c["v_scale"],
                                              mask)

        kd = (mine["k"].float() * mine["k_scale"]).transpose(1, 2)
        vd = (mine["v"].float() * mine["v_scale"]).transpose(1, 2)
        qh = q.transpose(1, 2)
        tm = {"ms": cuda_ms(torch, lambda: A.prefill_attention_kv8(q, k, v, mine, offset, mask),
                            iters=10),
              "graph_ms": graph_ms(torch, lambda: A.prefill_attention_kv8(q, k, v, mine, offset,
                                                                          mask)),
              "plain_ms": cuda_ms(torch, lambda: A._prefill_attention_kv8_plain(
                  q, k, v, theirs, offset, mask), iters=3, warmup=1),
              "replaced_ms": cuda_ms(torch, replaced, iters=10),
              "replaced_graph_ms": graph_ms(torch, replaced),
              "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                  qh, kd, vd, attn_mask=mask, scale=d ** -0.5), iters=10)}
        kept = float(mask.expand(b, 1, s, t).sum()) * h
        moved = (4.0 * b * s * h * d * 2 + 4.0 * 2 * b * s * h_kv * d
                 + 2.0 * b * (t - s) * h_kv * d + 2.0 * b * s * h_kv * d + 8.0 * b * t * h_kv
                 + b * s * t)
        tm["bound_ms"], tm["bound_by"] = bound_ms(moved, 3 * 4.0 * d * kept, PEAK_BF16_FLOPS)
        tm["f32_fma_bound_ms"], _ = bound_ms(moved, 4.0 * d * kept, PEAK_F32_FLOPS)
        tm["plan"] = A.tiled_kv8_plan(s, h // h_kv, d, True)
        tm["rel_err"], tm["max_abs_err"] = rel, err
        log(f"[kernel] attention_kv8 {name}: {tm['ms']:.4f} ms ({tm['graph_ms']:.4f} from a "
            f"CUDA graph), plain {tm['plain_ms']:.4f} ms, the replaced launches (quantize_rows "
            f"x2, four slice writes, the attention) {tm['replaced_ms']:.4f} ms "
            f"({tm['replaced_graph_ms']:.4f} from a graph), scaled_dot_product_attention on a "
            f"dequantized f32 cache {tm['library_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
            f"({tm['bound_by']}; f32 FMAs {tm['f32_fma_bound_ms']:.4f} ms); plan "
            f"{json.dumps(tm['plan'])}")
        record["shapes"][name] = tm
        if name == KV8_TILED_CASES[0][0]:
            record.update({key: tm[key] for key in ("ms", "graph_ms", "plain_ms", "replaced_ms",
                                                    "library_ms", "bound_ms", "bound_by")})
        del q, k, v, cache, mine, theirs, mask, out, ref, kd, vd, qh
        torch.cuda.empty_cache()
    return record


# the prefill's kernel with its cache write: the certify prefill, eval's, a
# caption's (batch 1), grouped-query heads and a 2048-position cache at an
# offset past 0: (batch, new rows, heads, kv heads, cached positions, the
# first new row's slot)
KV8_PREFILL_CASES = (
    ("certify prefill", MC_BATCH, RUN_CFG["seq_len"], LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, 0),
    ("eval prefill", EVAL_BATCH, EVAL_SEQ, LLAMA_HEADS, LLAMA_HEADS, EVAL_SEQ + 10, 0),
    ("caption prefill", 1, RUN_CFG["seq_len"], LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, 0),
    ("grouped", MC_BATCH, RUN_CFG["seq_len"], LLAMA_HEADS, 8, CACHE_LEN, 0),
    ("long cache", EVAL_BATCH, RUN_CFG["seq_len"], LLAMA_HEADS, LLAMA_HEADS, 2048, 1900))


def kv8_prefill_case(torch, device, g, b, s, h, h_kv, t, offset):
    """A prefill's q, k and v (bf16) and a quantized cache of ``t`` slots
    with the decoder's mask [B, 1, S, T] (``decoder_mask``)."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    d = LLAMA_HEAD_DIM
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=device).to(torch.bfloat16)
               for n in (h, h_kv, h_kv))
    kq, ks = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=device)
                             .to(torch.bfloat16))
    vq, vs = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=device)
                             .to(torch.bfloat16))
    return (q, k, v, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}, offset,
            decoder_mask(torch, device, b, s, t, offset))


def check_attention_kv8_prefill(torch, device):
    """The prefill's kernel against its plain version (the quantization,
    the slot writes and the plain attention) at ``KV8_PREFILL_CASES``: the
    cache's codes and scales bit for bit, the output within
    ``KV8_REL_LIMIT`` (relative Frobenius) and 2e-2 absolute, a fully masked
    row giving zeros. Each case timed eager and from a CUDA graph (alone):
    the kernel, the sequence it replaced (two ``quantize_rows`` launches,
    the four slice writes and ``multi_head_attention_kv8``, which now runs
    the prefill's kernel with no rows to write; and its quantization and
    writes apart) and ``scaled_dot_product_attention`` on the written cache
    dequantized to bf16 beforehand; the plain version at the certify
    prefill. The bound counts q, the new k and v rows and the cache's kept
    old slots read, the output, the codes and the scales written."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(11)
    record = {"max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": {}}
    d = LLAMA_HEAD_DIM
    for name, b, s, h, h_kv, t, offset in KV8_PREFILL_CASES:
        q, k, v, cache, offset, mask = kv8_prefill_case(torch, device, g, b, s, h, h_kv, t,
                                                        offset)
        mine, theirs = copy_cache(cache), copy_cache(cache)
        out = A.prefill_attention_kv8(q, k, v, mine, offset, mask)
        ref = A._prefill_attention_kv8_plain(q, k, v, theirs, offset, mask)
        torch.cuda.synchronize()
        off = cache_bits_unequal(torch, mine, theirs)
        rel, err = rel_err(out, ref), max_err(out, ref)
        zeros = b == 1 or not bool(out[-1].any())
        plan = A.prefill_kv8_plan(b, s, h, h_kv, t, offset, s)
        log(f"[kernel] attention_kv8_prefill {name} q [{b}, {s}, {h}, {d}], {s} new rows of "
            f"{h_kv} heads at slot {offset} of {t}: {off} cache codes and scales not "
            f"bit-identical to the plain version's; relative error (Frobenius) {rel:.3e}, max "
            f"abs {err:.3e}; fully masked row zeros: {zeros}; plan {json.dumps(plan)}")
        if off or not (rel < KV8_REL_LIMIT and err <= 2e-2) or not zeros:
            fail(f"attention_kv8_prefill disagrees with its plain version ({name})")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["max_rel_err"] = max(record["max_rel_err"], rel)

        def kernel():
            return A.prefill_attention_kv8(q, k, v, mine, offset, mask)

        def writes():
            kq, ks = Q.quantize_rows(k)
            vq, vs = Q.quantize_rows(v)
            at = slice(offset, offset + s)
            theirs["k"][:, at] = kq
            theirs["v"][:, at] = vq
            theirs["k_scale"][:, at] = ks
            theirs["v_scale"][:, at] = vs

        def replaced():
            writes()
            return A.multi_head_attention_kv8(q, theirs["k"], theirs["k_scale"], theirs["v"],
                                              theirs["v_scale"], mask)

        kd, vd = dequantized(torch, mine, h // h_kv)
        qh = q.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask, scale=d ** -0.5)

        tm = {"ms": cuda_ms(torch, kernel, iters=20), "graph_ms": graph_ms(torch, kernel),
              "replaced_ms": cuda_ms(torch, replaced, iters=20),
              "replaced_graph_ms": graph_ms(torch, replaced),
              "writes_ms": cuda_ms(torch, writes, iters=20),
              "writes_graph_ms": graph_ms(torch, writes),
              "library_ms": cuda_ms(torch, sdpa, iters=20),
              "library_graph_ms": graph_ms(torch, sdpa), "plan": plan}
        if name == "certify prefill":
            tm["plain_ms"] = cuda_ms(torch, lambda: A._prefill_attention_kv8_plain(
                q, k, v, theirs, offset, mask), iters=3, warmup=1)
        full = mask.expand(b, 1, s, t)[:, 0]
        kept = float(full.sum())
        new = torch.zeros(t, dtype=torch.bool, device=device)
        new[offset:offset + s] = True
        old_kept = float((full.any(dim=1) & ~new).sum())  # (batch row, old slot) pairs
        moved = (2.0 * 2 * b * s * h * d + 2.0 * 2 * b * s * h_kv * d  # q, out; the new k, v
                 + 2.0 * b * s * h_kv * d + 8.0 * b * s * h_kv  # their codes and scales
                 + (2.0 * d + 8.0) * h_kv * old_kept + b * s * t)  # kept old slots, the mask
        tm["bound_ms"], by = bound_ms(moved, 4.0 * d * h * kept, PEAK_BF16_FLOPS)
        log(f"[kernel] attention_kv8_prefill {name}: {tm['ms']:.4f} ms eager, "
            f"{tm['graph_ms']:.4f} ms alone (CUDA graph); the replaced sequence "
            f"{tm['replaced_ms']:.4f} ms eager, {tm['replaced_graph_ms']:.4f} ms alone (its "
            f"quantization and slice writes {tm['writes_ms']:.4f} / {tm['writes_graph_ms']:.4f} "
            f"ms); scaled_dot_product_attention on a dequantized bf16 cache "
            f"{tm['library_ms']:.4f} / {tm['library_graph_ms']:.4f} ms; "
            + (f"plain {tm['plain_ms']:.4f} ms; " if "plain_ms" in tm else "")
            + f"bound {tm['bound_ms']:.4f} ms ({by})")
        record["shapes"][name] = tm
        if name == "certify prefill":
            record.update(tm, bound_by=by)
        del q, k, v, cache, mine, theirs, mask, out, ref, kd, vd, qh
        torch.cuda.empty_cache()
    return record


# the decode step's kernel: the certify decode, a caption's, eval's,
# grouped-query heads and a long cache: (batch, heads, kv heads, cache
# positions, the step's slot)
KV8_DECODE_CASES = (("certify decode", MC_BATCH, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN,
                     CACHE_LEN - 2),
                    ("caption decode", 1, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, CACHE_LEN - 2),
                    ("eval decode", EVAL_BATCH, LLAMA_HEADS, LLAMA_HEADS, EVAL_SEQ + 10,
                     EVAL_SEQ + 1),
                    ("grouped", 4, LLAMA_HEADS, 8, 300, 299),
                    ("long cache", MC_BATCH, LLAMA_HEADS, LLAMA_HEADS, 2048, 2000))


def kv8_decode_case(torch, device, g, b, h, h_kv, t, offset, dtype=None):
    """A decode step's q, k and v (bf16, or ``dtype``) and a quantized cache
    of ``t`` slots with the decoder's mask [B, 1, 1, T]: slots after
    ``offset`` hidden, row 0 left-padded by two slots, the last batch row
    fully masked."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    d = LLAMA_HEAD_DIM
    q, k, v = (torch.randn((b, 1, n, d), generator=g, device=device).to(dtype or torch.bfloat16)
               for n in (h, h_kv, h_kv))
    kq, ks = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=device)
                             .to(torch.bfloat16))
    vq, vs = Q.quantize_rows(torch.randn((b, t, h_kv, d), generator=g, device=device)
                             .to(torch.bfloat16))
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    mask = (torch.arange(t, device=device) <= offset)[None, None, None, :] & \
        valid[:, None, None, :]
    return q, k, v, {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}, offset, mask


def copy_cache(cache):
    return {name: c.clone() for name, c in cache.items()}


def cache_bits_unequal(torch, a, b) -> int:
    return sum(bits_unequal(torch, a[name], b[name]) for name in a)


def check_attention_kv8_decode(torch, device):
    """The decode step's kernel against its plain version (the quantization,
    the slot writes and the plain attention) at ``KV8_DECODE_CASES``: the
    cache's codes and scales bit for bit, the output within
    ``KV8_REL_LIMIT`` (relative Frobenius) and 2e-2 absolute, a fully masked
    row giving zeros. The certify decode timed eager and from a CUDA graph
    against the plain version, the sequence the kernel replaced (two
    ``quantize_rows`` launches, the four slice writes and the attention
    launch of a lone row, which is now the decode kernel with nothing to
    write; eager and from a graph) and
    ``scaled_dot_product_attention`` on the cache dequantized to bf16
    beforehand; a caption's (batch 1) and the long cache timed too."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(10)
    record = {"max_abs_err": 0.0, "max_rel_err": 0.0, "shapes": {}}
    for name, b, h, h_kv, t, offset in KV8_DECODE_CASES:
        q, k, v, cache, offset, mask = kv8_decode_case(torch, device, g, b, h, h_kv, t, offset)
        mine, theirs = copy_cache(cache), copy_cache(cache)
        slot = torch.tensor(offset, dtype=torch.int32, device=device)
        on_card = copy_cache(cache)
        out = A.decode_attention_kv8(q, k, v, mine, offset, mask)
        ref = A._decode_attention_kv8_plain(q, k, v, theirs, offset, mask)
        # the slot read on the card (a decode loop's captured step): the
        # same launch, bit for bit the int slot's output and cache
        out_slot = A.decode_attention_kv8(q, k, v, on_card, slot, mask)
        torch.cuda.synchronize()
        off = cache_bits_unequal(torch, mine, theirs)
        slot_off = cache_bits_unequal(torch, on_card, mine) + bits_unequal(torch, out_slot, out)
        rel, err = rel_err(out, ref), max_err(out, ref)
        zeros = b == 1 or not bool(out[-1].any())
        log(f"[kernel] attention_kv8_decode {name} q [{b}, 1, {h}, {LLAMA_HEAD_DIM}] over {t} "
            f"cached positions of {h_kv} heads, slot {offset}: {off} cache codes and scales not "
            f"bit-identical to the plain version's; relative error (Frobenius) {rel:.3e}, max "
            f"abs {err:.3e}; fully masked row zeros: {zeros}; the slot on the card: {slot_off} "
            "output and cache values not bit-identical to the int slot's")
        if off or slot_off or not (rel < KV8_REL_LIMIT and err <= 2e-2) or not zeros:
            fail(f"attention_kv8_decode disagrees with its plain version or its int slot "
                 f"({name})")
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["max_rel_err"] = max(record["max_rel_err"], rel)
        if name in ("certify decode", "caption decode", "long cache"):
            def step():
                return A.decode_attention_kv8(q, k, v, mine, offset, mask)

            def replaced():
                kq, ks = Q.quantize_rows(k)
                vq, vs = Q.quantize_rows(v)
                at = slice(offset, offset + 1)
                theirs["k"][:, at] = kq
                theirs["v"][:, at] = vq
                theirs["k_scale"][:, at] = ks
                theirs["v_scale"][:, at] = vs
                return A.multi_head_attention_kv8(q, theirs["k"], theirs["k_scale"], theirs["v"],
                                                  theirs["v_scale"], mask)

            def slot_step():
                return A.decode_attention_kv8(q, k, v, on_card, slot, mask)

            tm = {"ms": cuda_ms(torch, step, iters=20), "graph_ms": graph_ms(torch, step),
                  "slot_ms": cuda_ms(torch, slot_step, iters=20),
                  "slot_graph_ms": graph_ms(torch, slot_step),
                  "plain_ms": cuda_ms(torch, lambda: A._decode_attention_kv8_plain(
                      q, k, v, theirs, offset, mask), iters=5, warmup=1),
                  "replaced_ms": cuda_ms(torch, replaced, iters=20),
                  "replaced_graph_ms": graph_ms(torch, replaced)}
            rep_ = h // h_kv
            kd = (mine["k"].float() * mine["k_scale"]).to(torch.bfloat16) \
                .repeat_interleave(rep_, 2).transpose(1, 2)
            vd = (mine["v"].float() * mine["v_scale"]).to(torch.bfloat16) \
                .repeat_interleave(rep_, 2).transpose(1, 2)
            qh = q.transpose(1, 2)
            tm["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=mask, scale=LLAMA_HEAD_DIM ** -0.5), iters=20)
            kept = float(mask.expand(b, 1, 1, t).sum())
            # the cache and its scales read, the batch row's mask, q, the
            # step's k and v read, the output and the slot's codes and
            # scales written
            moved = (2.0 * b * t * h_kv * LLAMA_HEAD_DIM + 8.0 * b * t * h_kv + b * t
                     + 2.0 * 2 * b * h * LLAMA_HEAD_DIM + 2.0 * 2 * b * h_kv * LLAMA_HEAD_DIM
                     + 2.0 * b * h_kv * LLAMA_HEAD_DIM + 8.0 * b * h_kv)
            tm["bound_ms"], by = bound_ms(moved, 4.0 * LLAMA_HEAD_DIM * h * kept,
                                          PEAK_BF16_FLOPS)
            log(f"[kernel] attention_kv8_decode {name}: {tm['ms']:.4f} ms eager, "
                f"{tm['graph_ms']:.4f} ms from a CUDA graph; with the slot on the card "
                f"{tm['slot_ms']:.4f} ms eager, {tm['slot_graph_ms']:.4f} ms from a CUDA graph; "
                f"plain {tm['plain_ms']:.4f} ms; the "
                f"replaced sequence {tm['replaced_ms']:.4f} ms eager, "
                f"{tm['replaced_graph_ms']:.4f} ms from a CUDA graph; "
                f"scaled_dot_product_attention on a dequantized bf16 cache "
                f"{tm['library_ms']:.4f} ms; bound {tm['bound_ms']:.4f} ms ({by})")
            record["shapes"][name] = tm
            if name == "certify decode":
                record.update(tm, bound_by=by)
            del kd, vd, qh
        del q, k, v, cache, mine, theirs, mask, out, ref, on_card, out_slot
        torch.cuda.empty_cache()
    return record


# the f32 instances (f32 configurations: f32 activations, int8 kernels and
# cache) at a tiny model's shapes and at the main path's
F32_QUANT_ROWS = ((5, 24), (MC_BATCH, LLAMA_WIDTH))
F32_EPILOGUE = ((7, 64, False), (MC_BATCH, 3 * VIT_WIDTH, True))
# the weight-only product: a tiny model's, the certify decode's q/k/v/o, a
# caption's gate/up and the prefill's down_proj (the deepest K)
F32_WEIGHT_ONLY = ((3, 64, 24), (MC_BATCH, LLAMA_WIDTH, LLAMA_WIDTH), (1, LLAMA_WIDTH, LLAMA_MLP),
                   (PREFILL_ROWS, LLAMA_MLP, LLAMA_WIDTH))
F32_KV8 = (("decode", MC_BATCH, 1, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, CACHE_LEN - 2),
           ("grouped", 4, 5, LLAMA_HEADS, 8, CACHE_LEN, 3))
F32_KV8_DECODE = (("certify decode", MC_BATCH, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN, CACHE_LEN - 2),
                  ("grouped", 4, LLAMA_HEADS, 8, CACHE_LEN, 3))
# the f32 weight-only kernel sums the exact products of x's three bf16 terms
# in f32, each 16-wide step's apart, in another order than cuBLAS: a few f32
# ulps (1.9e-6 measured at the prefill's down_proj, H100 80GB HBM3, 700 W)
F32_MATMUL_REL_LIMIT = 1e-5


def check_f32_instances(torch, device, records):
    """The five kernels' f32 instances against their plain versions: the
    row quantization and the epilogue bit for bit, the weight-only product
    within ``F32_MATMUL_REL_LIMIT``, the attention within ``KV8_REL_LIMIT``
    and the decode's kernel with its cache write bit for bit and its output
    within ``KV8_REL_LIMIT``; each timed against its plain version, into
    ``records[name]["f32"]``."""
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    g = torch.Generator(device=device).manual_seed(9)

    def record(name, shape, kernel, plain, off, rel, **extra):
        ms = cuda_ms(torch, kernel, iters=10)
        plain_ms = cuda_ms(torch, plain, iters=3, warmup=1)
        log(f"[kernel] {name} f32 {shape}: {off} outputs not bit-identical, relative error "
            f"(Frobenius) {rel:.3e}; {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + "".join(f"; {key} {json.dumps(v)}" for key, v in extra.items()))
        records[name].setdefault("f32", {})[shape] = {"ms": ms, "plain_ms": plain_ms,
                                                      "rel_err": rel, "off": off, **extra}

    for m, k in F32_QUANT_ROWS:
        x = torch.randn((m, k), generator=g, device=device) * 3
        got, want = Q.quantize_rows(x), Q._quantize_rows_plain(x)
        torch.cuda.synchronize()
        off = bits_unequal(torch, got[0], want[0]) + bits_unequal(torch, got[1], want[1])
        record("quant_rows", f"{m}x{k}", lambda: Q.quantize_rows(x),
               lambda: Q._quantize_rows_plain(x), off, 0.0)
        if off:
            fail(f"quant_rows' f32 instance disagrees with its plain version at [{m}, {k}]")
    for m, n, with_bias in F32_EPILOGUE:
        acc = torch.randint(-2 ** 23, 2 ** 23, (m, n), generator=g, device=device,
                            dtype=torch.int32)
        xs = torch.rand((m, 1), generator=g, device=device) * 1e-2 + 1e-3
        ws = torch.rand(n, generator=g, device=device) * 1e-4
        bias = torch.randn(n, generator=g, device=device) * 0.1 if with_bias else None
        out = Q.w8a8_epilogue(acc, xs, ws, bias, torch.float32)
        ref = Q._w8a8_epilogue_plain(acc, xs, ws, bias, torch.float32)
        torch.cuda.synchronize()
        off = bits_unequal(torch, out, ref)
        record("w8a8_epilogue", f"{m}x{n}", lambda: Q.w8a8_epilogue(acc, xs, ws, bias,
                                                                    torch.float32),
               lambda: Q._w8a8_epilogue_plain(acc, xs, ws, bias, torch.float32), off, 0.0)
        if off or out.dtype != torch.float32:
            fail(f"w8a8_epilogue's f32 instance disagrees with its plain chain at [{m}, {n}]")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 product in full
    try:
        for m, k, n in F32_WEIGHT_ONLY:
            kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g,
                                                    device=device, dtype=torch.int8))
            scale = torch.rand(n, generator=g, device=device) * 1e-3
            x = torch.randn((m, k), generator=g, device=device)
            out = Q.int8_weight_forward(x, kq, scale)
            ref = Q._int8_weight_forward_plain(x, kq, scale)
            torch.cuda.synchronize()
            rel = rel_err(out, ref)
            moved = 1.0 * k * n + 4.0 * m * k + 4.0 * m * n + 4.0 * n
            bound, by = bound_ms(moved, 3 * 2.0 * m * k * n, PEAK_BF16_FLOPS)
            # the plain version is the upcast plus cuBLAS's f32 product (TF32 off)
            record("int8_weight_matmul", f"{m}x{k}x{n}",
                   lambda: Q.int8_weight_forward(x, kq, scale),
                   lambda: Q._int8_weight_forward_plain(x, kq, scale), 0, rel,
                   graph_ms=graph_ms(torch, lambda: Q.int8_weight_forward(x, kq, scale)),
                   bound_ms=bound, bound_by=by,
                   f32_fma_bound_ms=bound_ms(moved, 2.0 * m * k * n, PEAK_F32_FLOPS)[0],
                   plan=weight_only_plan(m, k, n, f32=True))
            if not (math.isfinite(rel) and rel < F32_MATMUL_REL_LIMIT) \
                    or out.dtype != torch.float32:
                fail(f"int8_weight_matmul's f32 instance disagrees with its plain version at "
                     f"[{m}, {k}] x [{k}, {n}] (relative {rel:.3e})")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for name, b, sq, h, h_kv, t, offset in F32_KV8:
        _, *rest = kv8_case(torch, device, g, b, sq, h, h_kv, t, offset)
        args = (torch.randn((b, sq, h, LLAMA_HEAD_DIM), generator=g, device=device), *rest)
        before = kv8_counters()
        out = A.multi_head_attention_kv8(*args)
        kernel = kernel_of(before)
        ref = A._multi_head_attention_kv8_plain(*args)
        torch.cuda.synchronize()
        rel = rel_err(out, ref)
        owner = "attention_kv8" if kernel == "tiled" else f"attention_kv8_{kernel}"
        record(owner, name, lambda: A.multi_head_attention_kv8(*args),
               lambda: A._multi_head_attention_kv8_plain(*args), 0, rel)
        if not rel < KV8_REL_LIMIT or out.dtype != torch.float32 or bool(out[-1].any()) \
                or kernel != A.kv8_kernel(torch.float32, sq, LLAMA_HEAD_DIM, h // h_kv, False):
            fail(f"attention_kv8's f32 instance disagrees with its plain version ({name})")
    for name, b, h, h_kv, t, offset in F32_KV8_DECODE:
        q, k, v, cache, offset, mask = kv8_decode_case(torch, device, g, b, h, h_kv, t, offset,
                                                       torch.float32)
        mine, theirs = copy_cache(cache), copy_cache(cache)
        out = A.decode_attention_kv8(q, k, v, mine, offset, mask)
        ref = A._decode_attention_kv8_plain(q, k, v, theirs, offset, mask)
        torch.cuda.synchronize()
        off, rel = cache_bits_unequal(torch, mine, theirs), rel_err(out, ref)
        record("attention_kv8_decode", name,
               lambda: A.decode_attention_kv8(q, k, v, mine, offset, mask),
               lambda: A._decode_attention_kv8_plain(q, k, v, theirs, offset, mask), off, rel)
        if off or not rel < KV8_REL_LIMIT or out.dtype != torch.float32 \
                or bool(out[-1].any()):
            fail(f"attention_kv8_decode's f32 instance disagrees with its plain version ({name})")


# ----------------------------------------------------------------------
# phase 20: the decoder's fused elementwise ops (csrc/elementwise.cu)
# ----------------------------------------------------------------------
# the main path's calls of each op: (label, dtype, rows / q shape, width,
# with a residual, quantized); the first is the kernel's record shape (the
# prefill at the certify chunk)
FUSED_NORM_SHAPES = (("prefill, residual, codes", "bf16", PREFILL_ROWS, True, True),
                     ("prefill, first layer, codes", "bf16", PREFILL_ROWS, False, True),
                     ("prefill, final norm, rows", "bf16", PREFILL_ROWS, True, False),
                     ("decode, residual, rows", "bf16", MC_BATCH, True, False),
                     ("batch 1, residual, rows", "bf16", 1, True, False),
                     ("f32 prefill, residual, rows", "f32", F32_ROWS, True, False),
                     ("f32 decode, residual, rows", "f32", EVAL_BATCH, True, False))
FUSED_SILU_SHAPES = (("prefill, codes", "bf16", PREFILL_ROWS, True),
                     ("decode, rows", "bf16", MC_BATCH, False),
                     ("batch 1, rows", "bf16", 1, False),
                     ("f32 prefill, rows", "f32", F32_ROWS, False),
                     ("f32 decode, rows", "f32", EVAL_BATCH, False))
FUSED_ROTARY_SHAPES = (("prefill", "bf16", (MC_BATCH, RUN_CFG["seq_len"])),
                       ("decode", "bf16", (MC_BATCH, 1)), ("batch 1", "bf16", (1, 1)),
                       ("f32 prefill", "f32", (EVAL_BATCH, RUN_CFG["seq_len"])),
                       ("f32 decode", "f32", (EVAL_BATCH, 1)))
# f32 operations an element counted for the bounds: the norm's add, square,
# sum, two products, |x| and max, division, rounding and clip; SiLU x up's
# negation, add, division, two products and the same quantization, plus one
# exponential on the special-function unit; the rotary's two products and
# a sum
FUSED_NORM_OPS, FUSED_SILU_OPS, FUSED_ROTARY_OPS = 9, 10, 3
# the limits against the plain versions: the norm's rows within one ulp of
# bf16 (16 of f32: its sum of 4096 squares runs in the kernel's order, and
# the sums' difference of a few ulps passes through rsqrt; 5 seen), SiLU x up
# within one ulp (the toolkits' expf may differ), codes within one step on
# at most FUSED_CODES_SHARE of the elements with scales within 2^-7
# relative; the residual sum and the rotary bit for bit
FUSED_CODES_SHARE = 1e-3


def ulps_off(torch, got, want) -> float:
    """The largest |got - want| in ulps of want's dtype at want."""
    import numpy as np

    spacing = torch.from_numpy(np.spacing(want.float().abs().cpu().numpy())).to(want.device)
    if want.dtype == torch.bfloat16:
        spacing = spacing * 2.0 ** 16
    return float(((got.double() - want.double()).abs() / spacing.double()).max())


def fused_codes_ok(torch, got, want):
    """(ok, off share, largest dequantized difference) of two row
    quantizations."""
    off, frac, worst, rel, err = compare_codes(torch, got, want)
    return worst <= 1 and frac <= FUSED_CODES_SHARE and rel <= 2.0 ** -7, frac, err


def time_fused(torch, fn, plain, replaced, library=None):
    """ms eager (back to back), alone (from a CUDA graph), the plain
    version's, the replaced chain's and the library call's."""
    out = {"ms": cuda_ms(torch, fn, iters=20), "graph_ms": graph_ms(torch, fn),
           "plain_ms": cuda_ms(torch, plain, iters=5, warmup=1),
           "replaced_ms": cuda_ms(torch, replaced, iters=5, warmup=1)}
    out["library_ms"] = None if library is None else cuda_ms(torch, library, iters=20)
    return out


def fused_record(records):
    """The kernel's record: the first shape's times, every shape's under
    ``shapes``, the largest error over them."""
    first = next(iter(records.values()))
    return {"ms": first["ms"], "graph_ms": first["graph_ms"], "plain_ms": first["plain_ms"],
            "replaced_ms": first["replaced_ms"], "library_ms": first["library_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "max_abs_err": max(r["max_abs_err"] for r in records.values()), "shapes": records}


def phase_decoder_fusions(torch, device):
    """Phase 20: ``add_rms_norm``, ``rotary`` and ``silu_mul`` against
    their plain versions at the main path's shapes (the certify chunk's
    prefill, its decode step, batch 1; the f32 decoder's), each timed eager
    and alone (replayed from a CUDA graph) beside its bound, its plain
    version, the chain it replaced (the plain chain with ``quantize_rows``'
    kernel where it quantized) and, for the norm, ``F.rms_norm`` (the norm
    without a residual or codes: the one PyTorch call for part of it).
    Returns the three kernels' records."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import elementwise as E
    from certifiedgpt_tpu_torch.ops import quantization as Q

    t0 = time.perf_counter()
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device=device).manual_seed(20)

    def rows(m, k, dt, std=1.0):
        x = (std * torch.randn((m, k), generator=g, device=device)).to(dt)
        x[-1] = 0.0
        return x

    def chain_norm(x, y, scale, quantize):
        s, out = E._add_rms_norm_plain(x, y, scale, 1e-6)
        return s, (Q.quantize_rows(out) if quantize else out)

    norm = {}
    for label, dt, m, residual, quantize in FUSED_NORM_SHAPES:
        dtype = dtypes[dt]
        x, y = rows(m, LLAMA_WIDTH, dtype, 3.0), (rows(m, LLAMA_WIDTH, dtype) if residual else None)
        scale = (1.0 + 0.1 * torch.randn((LLAMA_WIDTH,), generator=g, device=device)).to(dtype)
        s, out = E.add_rms_norm(x, y, scale, 1e-6, quantize=quantize)
        ps, pout = E._add_rms_norm_plain(x, y, scale, 1e-6, quantize=quantize)
        torch.cuda.synchronize()
        sum_off = bits_unequal(torch, s, ps)
        if quantize:
            ok, frac, err = fused_codes_ok(torch, out, pout)
            what = f"codes off {frac:.2e} of the elements"
        else:
            ulps = ulps_off(torch, out, pout)
            ok, err = ulps <= (1 if dt == "bf16" else 16), float((out - pout).abs().max())
            what = f"rows {ulps:.0f} ulps off at most"
        rec = time_fused(torch, lambda: E.add_rms_norm(x, y, scale, 1e-6, quantize=quantize),
                         lambda: E._add_rms_norm_plain(x, y, scale, 1e-6, quantize=quantize),
                         lambda: chain_norm(x, y, scale, quantize),
                         lambda: F.rms_norm(x, (LLAMA_WIDTH,), scale, 1e-6))
        size = x.element_size()
        moved = m * LLAMA_WIDTH * size * (3 if residual else 1) + LLAMA_WIDTH * size
        moved += m * LLAMA_WIDTH + 4 * m if quantize else m * LLAMA_WIDTH * size
        bms, by = bound_ms(moved, FUSED_NORM_OPS * m * LLAMA_WIDTH, PEAK_F32_FLOPS)
        rec.update(bound_ms=bms, bound_by=by, max_abs_err=err, sum_bits_off=sum_off)
        norm[f"{label} [{m}, {LLAMA_WIDTH}] {dt}"] = rec
        log(f"[fused] 20 add_rms_norm {label} [{m}, {LLAMA_WIDTH}] {dt}: sum bits off {sum_off}, "
            f"{what}; {rec['ms']:.4f} ms eager, {rec['graph_ms']:.4f} ms alone, bound "
            f"{bms:.4f} ms ({by}), plain {rec['plain_ms']:.4f} ms, replaced chain "
            f"{rec['replaced_ms']:.4f} ms, F.rms_norm (no residual, no codes) "
            f"{rec['library_ms']:.4f} ms")
        if sum_off or not ok:
            fail(f"add_rms_norm disagrees with its plain version ({label}, {dt})")
        del x, y, s, out, ps, pout

    def chain_silu(gate, up, quantize):
        out = E._silu_mul_plain(gate, up)
        return Q.quantize_rows(out) if quantize else out

    silu = {}
    for label, dt, m, quantize in FUSED_SILU_SHAPES:
        dtype = dtypes[dt]
        gate, up = rows(m, LLAMA_MLP, dtype, 3.0), rows(m, LLAMA_MLP, dtype)
        out = E.silu_mul(gate, up, quantize=quantize)
        pout = E._silu_mul_plain(gate, up, quantize=quantize)
        torch.cuda.synchronize()
        if quantize:
            ok, frac, err = fused_codes_ok(torch, out, pout)
            off = bits_unequal(torch, out[0], pout[0])
            what = f"codes off {frac:.2e} of the elements ({off} codes)"
        else:
            ulps, off = ulps_off(torch, out, pout), bits_unequal(torch, out, pout)
            ok, err = ulps <= 1, float((out - pout).abs().max())
            what = f"rows {ulps:.0f} ulps off at most ({off} values not bit-identical)"
        rec = time_fused(torch, lambda: E.silu_mul(gate, up, quantize=quantize),
                         lambda: E._silu_mul_plain(gate, up, quantize=quantize),
                         lambda: chain_silu(gate, up, quantize))
        size = gate.element_size()
        moved = 2 * m * LLAMA_MLP * size + (m * LLAMA_MLP + 4 * m if quantize
                                            else m * LLAMA_MLP * size)
        bms, by = bound_ms(moved, FUSED_SILU_OPS * m * LLAMA_MLP, PEAK_F32_FLOPS,
                           (m * LLAMA_MLP, PEAK_MUFU_OPS))
        rec.update(bound_ms=bms, bound_by=by, max_abs_err=err, bits_off=off)
        silu[f"{label} [{m}, {LLAMA_MLP}] {dt}"] = rec
        log(f"[fused] 20 silu_mul {label} [{m}, {LLAMA_MLP}] {dt}: {what}; {rec['ms']:.4f} ms "
            f"eager, {rec['graph_ms']:.4f} ms alone, bound {bms:.4f} ms ({by}), plain "
            f"{rec['plain_ms']:.4f} ms, replaced chain {rec['replaced_ms']:.4f} ms")
        if not ok:
            fail(f"silu_mul disagrees with its plain version ({label}, {dt})")
        del gate, up, out, pout

    rotary = {}
    cos, sin = E.rotary_tables(LLAMA_HEAD_DIM, 4096, 10000.0, device)
    for label, dt, (b, sq) in FUSED_ROTARY_SHAPES:
        dtype = dtypes[dt]
        q = torch.randn((b, sq, LLAMA_HEADS, LLAMA_HEAD_DIM), generator=g, device=device).to(dtype)
        k = torch.randn((b, sq, LLAMA_HEADS, LLAMA_HEAD_DIM), generator=g, device=device).to(dtype)
        pos = (torch.arange(sq, device=device)[None] + torch.arange(b, device=device)[:, None]
               + (RUN_CFG["seq_len"] if sq == 1 else 0))
        want_q, want_k = E._rotary_plain(q, k, cos, sin, pos)
        got_q, got_k = E.rotary(q.clone(), k.clone(), cos, sin, pos)
        torch.cuda.synchronize()
        off = bits_unequal(torch, got_q, want_q) + bits_unequal(torch, got_k, want_k)
        err = max(float((got_q - want_q).abs().max()), float((got_k - want_k).abs().max()))
        rec = time_fused(torch, lambda: E.rotary(q, k, cos, sin, pos),
                         lambda: E._rotary_plain(q, k, cos, sin, pos),
                         lambda: E._rotary_plain(q, k, cos, sin, pos))
        n = q.numel() + k.numel()
        bms, by = bound_ms(2 * n * q.element_size() + 8 * b * sq, FUSED_ROTARY_OPS * n,
                           PEAK_F32_FLOPS)
        rec.update(bound_ms=bms, bound_by=by, max_abs_err=err, bits_off=off)
        rotary[f"{label} q, k [{b}, {sq}, {LLAMA_HEADS}, {LLAMA_HEAD_DIM}] {dt}"] = rec
        log(f"[fused] 20 rotary {label} q, k [{b}, {sq}, {LLAMA_HEADS}, {LLAMA_HEAD_DIM}] {dt}: "
            f"{off} values not bit-identical to the plain version; {rec['ms']:.4f} ms eager, "
            f"{rec['graph_ms']:.4f} ms alone, bound {bms:.4f} ms ({by}), plain (the replaced "
            f"chain) {rec['plain_ms']:.4f} ms")
        if off:
            fail(f"rotary disagrees with its plain version ({label}, {dt})")
        del q, k, want_q, want_k, got_q, got_k
    torch.cuda.empty_cache()
    log(f"[fused] phase 20 took {time.perf_counter() - t0:.1f} s")
    return {"add_rms_norm": fused_record(norm), "rotary": fused_record(rotary),
            "silu_mul": fused_record(silu)}


# ----------------------------------------------------------------------
# phase 23: the backward kernels of the fused elementwise ops
# ----------------------------------------------------------------------
# a train step of the VQAv2 finetuning configs: 48 samples packed 3 to a row
# of 256 tokens
TRAIN_ROWS = TRAIN_BATCH // 3
TRAIN_SEQ = 256
TRAIN_TOKENS = TRAIN_ROWS * TRAIN_SEQ
# (label, dtype, rows, the stream's gradient from later uses given); the
# first is the record's shape: a middle layer of a train step
GRAD_NORM_SHAPES = (("train step, residual", "bf16", TRAIN_TOKENS, True),
                    ("train step, first layer", "bf16", TRAIN_TOKENS, False),
                    ("batch 1, residual", "bf16", 1, True),
                    ("f32, residual", "f32", F32_ROWS, True))
GRAD_SILU_SHAPES = (("train step", "bf16", TRAIN_TOKENS), ("batch 1", "bf16", 1),
                    ("f32", "f32", F32_ROWS))
GRAD_ROTARY_SHAPES = (("train step", "bf16", (TRAIN_ROWS, TRAIN_SEQ)), ("batch 1", "bf16", (1, 1)),
                      ("f32", "f32", (EVAL_BATCH, RUN_CFG["seq_len"])))
# f32 operations an element counted for the bounds: the norm's g w, s^2 and
# its sum, g w s and its sum, g w r, 2 s and its product, the add and the
# gradient's add; the rotary's two products and a sum; the SiLU's negation,
# two adds, two divisions, four products, a subtraction and a fused
# multiply-add, plus one exponential on the special-function unit
GRAD_NORM_OPS, GRAD_ROTARY_OPS, GRAD_SILU_OPS = 10, 3, 11
# the norm's backward against its plain version: its two row sums (of s^2
# and of g w s) run in the kernel's order. Two orders of a K-term f32 sum
# differ by at most 2 (K - 1) units of roundoff (2^-24) of the sum of the
# terms' magnitudes (recursive summation's bound; 2^-11 at K = 4096), which
# moves r relatively by half that and the second term's factor r^3 by three
# halves. So an element may differ by the dtype's rounding of either side
# (an ulp at the result and at the norm's term) plus that share of |g w r|,
# 3 |the second term| and the second term with every product of its sum
# taken positive, and of |gs| where f32 adds it before rounding. The
# rotary's and the SiLU's bit for bit.


def norm_grad_slack(torch, s, g, gs, scale, gx_plain, eps=1e-6):
    """``add_rms_norm_grad``'s tolerance against its plain version,
    element by element (above)."""
    import numpy as np

    def ulp(t, dtype):
        out = torch.from_numpy(np.spacing(t.abs().float().cpu().numpy())).to(t.device)
        return out * (2.0 ** 16 if dtype == torch.bfloat16 else 1.0)

    s32 = s.float()
    gw = g.float() * scale.float()
    r = torch.rsqrt(s32.square().mean(dim=-1, keepdim=True) + eps)
    k = s.shape[-1]
    a = gw * r
    b = ((-0.5 * (gw * s32).sum(dim=-1, keepdim=True)) * r.pow(3) / k) * (2.0 * s32)
    b_abs = ((0.5 * (gw * s32).abs().sum(dim=-1, keepdim=True)) * r.pow(3) / k) * (2.0 * s32.abs())
    return ulp(gx_plain, s.dtype) + ulp(a + b, s.dtype) + 2 * (k - 1) * 2.0 ** -24 * (
        a.abs() + 3.0 * b.abs() + b_abs + (0.0 if gs is None else gs.float().abs()))


def time_grad(torch, fn, plain, replaced):
    """ms eager, alone (from a CUDA graph), the plain version's and the
    replaced autograd backward's."""
    return {"ms": cuda_ms(torch, fn, iters=20), "graph_ms": graph_ms(torch, fn),
            "plain_ms": cuda_ms(torch, plain, iters=5, warmup=1),
            "replaced_ms": cuda_ms(torch, replaced, iters=5, warmup=1), "library_ms": None}


def autograd_backward(torch, forward, inputs, cotangents):
    """A call that runs autograd's backward of ``forward`` (the plain chain)
    on a graph built once: the backward the kernel replaced (autograd on,
    whatever the caller's mode)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        outs = forward(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)

    def backward():
        with torch.enable_grad():
            return torch.autograd.grad(outs, leaves, cotangents, retain_graph=True)

    return backward


def phase_decoder_grads(torch, device):
    """Phase 23: ``add_rms_norm_grad``, ``rotary_grad`` and
    ``silu_mul_grad`` against their plain versions at a train step's shapes
    (16 packed rows x 256 tokens), a batch-1 row and f32, each timed eager
    and alone (replayed from a CUDA graph) beside its bound, its plain
    version and autograd's backward of the plain chain (what the training
    step ran before the kernels). Returns the three kernels' records."""
    from certifiedgpt_tpu_torch.ops import elementwise as E

    t0 = time.perf_counter()
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device=device).manual_seed(23)

    def normal(shape, dt, std=1.0):
        return (std * torch.randn(shape, generator=g, device=device)).to(dt)

    norm = {}
    for label, dt, m, residual in GRAD_NORM_SHAPES:
        dtype = dtypes[dt]
        s, gout = normal((m, LLAMA_WIDTH), dtype, 3.0), normal((m, LLAMA_WIDTH), dtype)
        gs = normal((m, LLAMA_WIDTH), dtype) if residual else None
        scale = (1.0 + 0.1 * torch.randn((LLAMA_WIDTH,), generator=g, device=device)).to(dtype)
        got = E.add_rms_norm_grad(s, gout, gs, scale)
        want = E._add_rms_norm_grad_plain(s, gout, gs, scale)
        torch.cuda.synchronize()
        off = bits_unequal(torch, got, want)
        diff = (got.float() - want.float()).abs()
        share = float((diff / norm_grad_slack(torch, s, gout, gs, scale, want)).max())
        ulps = ulps_off(torch, got, want)
        rec = time_grad(
            torch, lambda: E.add_rms_norm_grad(s, gout, gs, scale),
            lambda: E._add_rms_norm_grad_plain(s, gout, gs, scale),
            autograd_backward(torch, lambda x: (x, E.rms_norm_plain(x, scale)), (s,),
                              (torch.zeros_like(s) if gs is None else gs, gout)))
        size = s.element_size()
        moved = m * LLAMA_WIDTH * size * (4 if residual else 3) + LLAMA_WIDTH * size
        bms, by = bound_ms(moved, GRAD_NORM_OPS * m * LLAMA_WIDTH, PEAK_F32_FLOPS)
        rec.update(bound_ms=bms, bound_by=by, max_abs_err=float(diff.max()), bits_off=off,
                   tolerance_share=share)
        norm[f"{label} [{m}, {LLAMA_WIDTH}] {dt}"] = rec
        log(f"[grad] 23 add_rms_norm_grad {label} [{m}, {LLAMA_WIDTH}] {dt}: {off} values not "
            f"bit-identical to the plain version ({ulps:.0f} ulps at most, {share:.3f} of the "
            f"tolerance); {rec['ms']:.4f} ms eager, {rec['graph_ms']:.4f} ms alone, bound "
            f"{bms:.4f} ms ({by}), plain {rec['plain_ms']:.4f} ms, autograd's backward of the "
            f"plain chain {rec['replaced_ms']:.4f} ms")
        if not share <= 1.0:
            fail(f"add_rms_norm_grad disagrees with its plain version ({label}, {dt})")
        del s, gout, gs, got, want, diff

    silu = {}
    for label, dt, m in GRAD_SILU_SHAPES:
        dtype = dtypes[dt]
        gate, up = normal((m, LLAMA_MLP), dtype, 3.0), normal((m, LLAMA_MLP), dtype)
        gout = normal((m, LLAMA_MLP), dtype)
        got = E.silu_mul_grad(gout, gate, up)
        want = E._silu_mul_grad_plain(gout, gate, up)
        torch.cuda.synchronize()
        offs = [bits_unequal(torch, a, b) for a, b in zip(got, want)]
        err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        rec = time_grad(torch, lambda: E.silu_mul_grad(gout, gate, up),
                        lambda: E._silu_mul_grad_plain(gout, gate, up),
                        autograd_backward(torch, E._silu_mul_plain, (gate, up), (gout,)))
        size = gate.element_size()
        bms, by = bound_ms(5 * m * LLAMA_MLP * size, GRAD_SILU_OPS * m * LLAMA_MLP, PEAK_F32_FLOPS,
                           (m * LLAMA_MLP, PEAK_MUFU_OPS))
        rec.update(bound_ms=bms, bound_by=by, max_abs_err=err, bits_off=sum(offs))
        silu[f"{label} [{m}, {LLAMA_MLP}] {dt}"] = rec
        log(f"[grad] 23 silu_mul_grad {label} [{m}, {LLAMA_MLP}] {dt}: {offs[0]} + {offs[1]} "
            f"values of g_gate, g_up not bit-identical to the plain version (largest difference "
            f"{err:.3e}); {rec['ms']:.4f} ms eager, {rec['graph_ms']:.4f} ms alone, bound "
            f"{bms:.4f} ms ({by}), plain {rec['plain_ms']:.4f} ms, autograd's backward of the "
            f"plain chain {rec['replaced_ms']:.4f} ms")
        if sum(offs):
            fail(f"silu_mul_grad disagrees with its plain version ({label}, {dt})")
        del gate, up, gout, got, want

    rotary = {}
    cos, sin = E.rotary_tables(LLAMA_HEAD_DIM, 4096, 10000.0, device)
    for label, dt, (b, sq) in GRAD_ROTARY_SHAPES:
        dtype = dtypes[dt]
        shape = (b, sq, LLAMA_HEADS, LLAMA_HEAD_DIM)
        gq, gk = normal(shape, dtype), normal(shape, dtype)
        # packed rows: the positions restart at each of three segments
        pos = torch.arange(sq, device=device)[None].expand(b, sq) % max(1, (sq + 2) // 3)
        got = E.rotary_grad(gq, gk, cos, sin, pos)
        want = E._rotary_grad_plain(gq, gk, cos, sin, pos)
        torch.cuda.synchronize()
        off = bits_unequal(torch, got[0], want[0]) + bits_unequal(torch, got[1], want[1])
        err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
        rec = time_grad(torch, lambda: E.rotary_grad(gq, gk, cos, sin, pos),
                        lambda: E._rotary_grad_plain(gq, gk, cos, sin, pos),
                        autograd_backward(torch, lambda q, k: E._rotary_plain(q, k, cos, sin, pos),
                                          (gq, gk), (gq, gk)))
        n = gq.numel() + gk.numel()
        bms, by = bound_ms(2 * n * gq.element_size() + 8 * b * sq, GRAD_ROTARY_OPS * n,
                           PEAK_F32_FLOPS)
        rec.update(bound_ms=bms, bound_by=by, max_abs_err=err, bits_off=off)
        rotary[f"{label} q, k {list(shape)} {dt}"] = rec
        log(f"[grad] 23 rotary_grad {label} q, k {list(shape)} {dt}: {off} values not "
            f"bit-identical to the plain version; {rec['ms']:.4f} ms eager, "
            f"{rec['graph_ms']:.4f} ms alone, bound {bms:.4f} ms ({by}), plain "
            f"{rec['plain_ms']:.4f} ms, autograd's backward of the plain chain "
            f"{rec['replaced_ms']:.4f} ms")
        if off:
            fail(f"rotary_grad disagrees with its plain version ({label}, {dt})")
        del gq, gk, got, want
    torch.cuda.empty_cache()
    log(f"[grad] phase 23 took {time.perf_counter() - t0:.1f} s")
    return {"add_rms_norm_grad": fused_record(norm), "rotary_grad": fused_record(rotary),
            "silu_mul_grad": fused_record(silu)}


# ----------------------------------------------------------------------
# phase 24: the train step's straight-through gradient and training attention
# ----------------------------------------------------------------------
# the straight-through input gradients of a _w8a8 train step: (label, rows
# of g, out (the forward's N, the reduction here), in (the output width))
GRAD_GEMM_SHAPES = (("q/k/v/o", TRAIN_TOKENS, LLAMA_WIDTH, LLAMA_WIDTH),
                    ("gate/up", TRAIN_TOKENS, LLAMA_MLP, LLAMA_WIDTH),
                    ("down", TRAIN_TOKENS, LLAMA_WIDTH, LLAMA_MLP))
# the kernel against its plain version (cuBLAS on the dequantized weight):
# both round f32 sums of the same exact products to bf16, in other orders.
# Two orders of an N-term f32 sum differ by at most 2 (N - 1) units of
# roundoff (2^-24) of the sum of the terms' magnitudes (|g| @ |w|^T), and
# the rounding to bf16 then by an ulp of the result
GRAD_GEMM_SUM_SLACK = 2.0 ** -24
# (label, rows, tokens a row, packed, left-padded rows); the first is the
# record's shape: a train step's layer (16 rows of 256, three segments and
# pad slots a row), then a validation batch (48 unpacked rows, right
# padding), left padding (queries that see no key), and a length that is
# no multiple of the kernels' 64-row tiles
TRAIN_ATTN_SHAPES = (("train step, packed", TRAIN_ROWS, TRAIN_SEQ, True, False),
                     ("validation batch, unpacked", TRAIN_BATCH, TRAIN_SEQ, False, False),
                     ("left padding", 4, TRAIN_SEQ, False, True),
                     ("packed, 200 tokens", 4, 200, True, False))
# kernels against the plain version under autograd (f32 products, TF32
# off), as relative (Frobenius) errors: the output and dv sum bf16-rounded
# weights, which an f32 ulp of the normalized weight flips in rare elements
# (2^-8 of that term), and round to bf16 (2^-9); dq and dk take dS, whose
# factor dP is bf16-rounded from sums in other orders, and dS's three bf16
# terms hold its whole f32 significand
TRAIN_ATTN_REL = {"out": 4e-3, "dq": 1e-2, "dk": 1e-2, "dv": 4e-3}


def grad_gemm_case(torch, device, g, m, n, k):
    """An int8 kernel [k, n] (column-major, seeded codes), its f32 channel
    scales and bf16 rows g [m, n]."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    kq = torch.randint(-127, 128, (n, k), generator=g, device=device, dtype=torch.int8).t()
    scale = (torch.rand((n,), generator=g, device=device) + 0.5) * 2e-3
    rows = torch.randn((m, n), generator=g, device=device).bfloat16()
    return Q.int8_kernel_layout(kq), scale, rows


def check_w8_grad_gemm(torch, device):
    """Kernel A: ``w8_grad_gemm`` at a train step's three shapes: an
    identity ``g`` reads back each dequantized weight bit for bit (one
    product of 1 and the weight, summed with zeros), the products within
    the sum-order tolerance of ``_grad_input_plain``; eager, alone, the
    chain it replaced (``_dequantized_t`` + cuBLAS), cuBLAS on a bf16 weight
    made beforehand, the bound."""
    import numpy as np

    import sass_count
    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import quantization as Q

    counts = sass_count.opcode_counts(sass_count.sass_of(cuda_kernels.build().path),
                                      "w8_grad_gemm_kernel")
    hgmma = {fn: ops.get("HGMMA", 0) for fn, ops in counts.items()}
    i2f = {fn: ops.get("I2F", 0) for fn, ops in counts.items()}
    log(f"[train] 24 w8_grad_gemm SASS: HGMMA {hgmma}, I2F {i2f}")
    if not hgmma or not all(hgmma.values()):
        fail(f"w8_grad_gemm holds no HGMMA instruction: {hgmma}")
    g = torch.Generator(device=device).manual_seed(24)
    shapes = {}
    for label, m, n, k in GRAD_GEMM_SHAPES:
        kq, scale, rows = grad_gemm_case(torch, device, g, m, n, k)
        eye = torch.eye(n, device=device, dtype=torch.bfloat16)
        tile_off = bits_unequal(torch, Q.w8_grad_gemm(eye, kq, scale),
                                Q._dequantized_t(kq, scale, torch.bfloat16))
        del eye
        got = Q.w8_grad_gemm(rows, kq, scale)
        want = Q._grad_input_plain(rows, kq, scale, torch.bfloat16)
        w_t = Q._dequantized_t(kq, scale, torch.bfloat16)
        mag = rows.float().abs() @ w_t.float().abs()
        torch.cuda.synchronize()
        slack = 2.0 * (n - 1) * GRAD_GEMM_SUM_SLACK * mag
        ulp = torch.from_numpy(np.spacing(want.float().abs().cpu().numpy())).to(device) * 2.0 ** 16
        diff = (got.float() - want.float()).abs()
        share = float((diff / (ulp + slack)).max())
        err = float(diff.max())
        del mag, slack, ulp, diff
        w_bf16 = w_t.contiguous()
        rec = {"ms": cuda_ms(torch, lambda: Q.w8_grad_gemm(rows, kq, scale), iters=10),
               "graph_ms": graph_ms(torch, lambda: Q.w8_grad_gemm(rows, kq, scale), iters=10),
               "plain_ms": cuda_ms(torch, lambda: Q._grad_input_plain(rows, kq, scale,
                                                                      torch.bfloat16), iters=5),
               "replaced_graph_ms": graph_ms(
                   torch, lambda: Q._grad_input_plain(rows, kq, scale, torch.bfloat16),
                   iters=10),
               "library_ms": graph_ms(torch, lambda: torch.matmul(rows, w_bf16), iters=10)}
        rec["replaced_ms"] = rec["plain_ms"]
        moved = 2 * m * n + k * n + 4 * n + 2 * m * k
        rec["bound_ms"], rec["bound_by"] = bound_ms(moved, 2.0 * m * n * k, PEAK_BF16_FLOPS)
        rec.update(max_abs_err=err, tolerance_share=share, tile_bits_off=tile_off)
        shapes[f"{label} [{m},{n}]x[{k},{n}]^T"] = rec
        faster = rec["graph_ms"] <= rec["replaced_graph_ms"]
        log(f"[train] 24 w8_grad_gemm {label} g [{m}, {n}] x int8 [{k}, {n}]^T: dequantized "
            f"tile {tile_off} values off; products {share:.3f} of the sum-order tolerance "
            f"(largest difference {err:.3e}); {rec['ms']:.4f} ms eager, {rec['graph_ms']:.4f} "
            f"ms alone ({rec['bound_ms'] / rec['graph_ms']:.0%} of the bound "
            f"{rec['bound_ms']:.4f} ms, {rec['bound_by']}); the replaced _dequantized_t + "
            f"cuBLAS {rec['replaced_graph_ms']:.4f} ms alone ({rec['plain_ms']:.4f} eager); "
            f"cuBLAS on a bf16 weight made beforehand {rec['library_ms']:.4f} ms; no slower "
            f"than the replaced pair: {faster}")
        if tile_off:
            fail(f"w8_grad_gemm's dequantized weight differs from _dequantized_t's ({label})")
        if not share <= 1.0:
            fail(f"w8_grad_gemm disagrees with its plain version ({label})")
        del kq, scale, rows, got, want, w_t, w_bf16
    torch.cuda.empty_cache()
    rec = fused_record(shapes)
    rec["sass_hgmma"] = hgmma
    return rec


def train_attention_case(torch, device, g, b, s, packed, left):
    """q, k, v, the output's gradient [b, s, 32, 128] bf16 (scaled as a
    decoder's are), the keys' validity and the segment ids (packed: three
    segments a row, its last sixth pad slots of id 0; unpacked: None)."""
    shape = (b, s, LLAMA_HEADS, LLAMA_HEAD_DIM)
    q, k, v, go = (torch.randn(shape, generator=g, device=device).bfloat16() for _ in range(4))
    idx = torch.arange(s, device=device)
    valid = torch.ones((b, s), dtype=torch.long, device=device)
    seg = None
    if packed:
        used = s - s // 6
        seg = torch.where(idx < used, 1 + (idx * 3) // used, 0)[None].repeat(b, 1)
        valid[:, used:] = 0
    elif left:
        valid[:, : s // 8] = 0  # the first queries see no valid key
    else:
        valid[1::2, s - s // 5:] = 0  # every other row right-padded
    return q, k, v, go, valid, seg


def check_train_attention(torch, device):
    """Kernels B and C: ``training_attention`` forward and backward
    (``train_attention_fwd``, ``train_attention_dq``, ``train_attention_dkv``)
    against ``_training_attention_plain`` and its autograd backward at a
    train step's layer, a validation batch, left padding and a ragged
    length; queries that see no key give exact zeros; eager, alone (a CUDA
    graph), the plain version, SDPA with the same mask."""
    import torch.nn.functional as F

    from certifiedgpt_tpu_torch.ops import attention as A

    g = torch.Generator(device=device).manual_seed(25)
    fwd, bwd_q, bwd_kv = {}, {}, {}
    for label, b, s, packed, left in TRAIN_ATTN_SHAPES:
        q, k, v, go, valid, seg = train_attention_case(torch, device, g, b, s, packed, left)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            out = A.training_attention(*leaves, valid, seg)
            grads = torch.autograd.grad(out, leaves, go)
            pleaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            pout = A._training_attention_plain(*pleaves, valid, seg)
            pgrads = torch.autograd.grad(pout, pleaves, go)
        torch.cuda.synchronize()
        errs = {"out": rel_err(out, pout)}
        errs.update({name: rel_err(a, w) for name, a, w in zip(("dq", "dk", "dv"), grads, pgrads)})
        mask = A.training_mask(valid, seg, s, device)
        dead = ~mask.any(dim=-1)[:, 0]  # [b, s]: queries that see no key
        dead_ok = not (bool(out[dead].any()) or bool(grads[0][dead].any()))
        n_dead = int(dead.sum())
        args = A._train_attention_args(q, k, v, valid, seg)
        scale = LLAMA_HEAD_DIM ** -0.5
        o2, mx, sm = A.train_attention_fwd(*args, scale)
        dq, dsum = A.train_attention_dq(*args, go, mx, sm, scale)

        def fwd_call():
            A.train_attention_fwd(*args, scale)

        def dq_call():
            A.train_attention_dq(*args, go, mx, sm, scale)

        def dkv_call():
            A.train_attention_dkv(*args, go, mx, sm, dsum, scale)

        def plain_fwd():
            A._training_attention_plain(q, k, v, valid, seg)

        plain_bwd = autograd_backward(
            torch, lambda a, bb, c: A._training_attention_plain(a, bb, c, valid, seg),
            (q, k, v), (go,))
        tq, tk, tv, tgo = (t.transpose(1, 2) for t in (q, k, v, go))

        def sdpa_fwd():
            F.scaled_dot_product_attention(tq, tk, tv, attn_mask=mask)

        sdpa_bwd = autograd_backward(
            torch, lambda a, bb, c: F.scaled_dot_product_attention(a, bb, c, attn_mask=mask),
            (tq, tk, tv), (tgo,))
        pairs = float(mask.sum()) * LLAMA_HEADS
        size = q.numel() * 2
        stats = 4 * b * LLAMA_HEADS * s
        frec = {"ms": cuda_ms(torch, fwd_call, iters=10), "graph_ms": graph_ms(torch, fwd_call),
                "plain_ms": cuda_ms(torch, plain_fwd, iters=3, warmup=1),
                "library_ms": graph_ms(torch, sdpa_fwd, iters=5)}
        frec["replaced_ms"] = frec["plain_ms"]
        frec["bound_ms"], frec["bound_by"] = bound_ms(4 * size + 2 * stats,
                                                      4.0 * pairs * LLAMA_HEAD_DIM,
                                                      PEAK_BF16_FLOPS)
        qrec = {"ms": cuda_ms(torch, dq_call, iters=10), "graph_ms": graph_ms(torch, dq_call)}
        krec = {"ms": cuda_ms(torch, dkv_call, iters=10), "graph_ms": graph_ms(torch, dkv_call)}
        plain_bwd_ms = cuda_ms(torch, plain_bwd, iters=3, warmup=1)
        sdpa_bwd_ms = cuda_ms(torch, sdpa_bwd, iters=5, warmup=1)
        # the backward's bytes: q, k, v, g and the statistics read, dq, dk,
        # dv written; its operations: P, dP, dv, dq and dk (two each a pair)
        bwd_bound, bwd_by = bound_ms(7 * size + 2 * stats, 10.0 * pairs * LLAMA_HEAD_DIM,
                                     PEAK_BF16_FLOPS)
        for rec in (qrec, krec):
            rec.update(plain_ms=plain_bwd_ms, replaced_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
                       bound_ms=bwd_bound, bound_by=bwd_by)
        frec["max_abs_err"] = float((out.float() - pout.float()).abs().max())
        qrec["max_abs_err"] = float((grads[0].float() - pgrads[0].float()).abs().max())
        krec["max_abs_err"] = max(float((a.float() - w.float()).abs().max())
                                  for a, w in zip(grads[1:], pgrads[1:]))
        for rec in (frec, qrec, krec):
            rec["rel_err"] = errs
        key = f"{label} [{b}, {s}, {LLAMA_HEADS}, {LLAMA_HEAD_DIM}]"
        fwd[key], bwd_q[key], bwd_kv[key] = frec, qrec, krec
        both = qrec["graph_ms"] + krec["graph_ms"]
        log(f"[train] 24 training attention {key}: relative errors against the plain version "
            f"{json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})} (limits "
            f"{json.dumps(TRAIN_ATTN_REL)}); {n_dead} queries that see no key exactly zero "
            f"with zero gradients: {dead_ok}; forward {frec['ms']:.4f} ms eager, "
            f"{frec['graph_ms']:.4f} ms alone (bound {frec['bound_ms']:.4f} ms, "
            f"{frec['bound_by']}), plain {frec['plain_ms']:.4f} ms, SDPA with the mask "
            f"{frec['library_ms']:.4f} ms; backward dq {qrec['graph_ms']:.4f} + dk, dv "
            f"{krec['graph_ms']:.4f} = {both:.4f} ms alone (bound {bwd_bound:.4f} ms, {bwd_by}), "
            f"autograd through the plain version {plain_bwd_ms:.4f} ms, SDPA's backward "
            f"{sdpa_bwd_ms:.4f} ms")
        if not all(errs[n] < TRAIN_ATTN_REL[n] for n in errs):
            fail(f"the training attention disagrees with its plain version ({label}): {errs}")
        if not dead_ok:
            fail(f"the training attention gives queries that see no key values ({label})")
        del q, k, v, go, leaves, out, grads, pleaves, pout, pgrads, args, o2, mx, sm, dq, dsum
        del plain_bwd, sdpa_bwd, mask, tq, tk, tv, tgo
        torch.cuda.empty_cache()
    return {"train_attention_fwd": fused_record(fwd), "train_attention_dq": fused_record(bwd_q),
            "train_attention_dkv": fused_record(bwd_kv)}


def phase_train_kernels(torch, device):
    """Phase 24: the straight-through input gradient reading the int8
    kernel (kernel A) and the training attention forward and backward
    (kernels B and C) against their plain versions at a train step's
    shapes."""
    t0 = time.perf_counter()
    records = {"w8_grad_gemm": check_w8_grad_gemm(torch, device)}
    records.update(check_train_attention(torch, device))
    log(f"[train] phase 24 took {time.perf_counter() - t0:.1f} s")
    return records


def phase_kernels(torch, device):
    from certifiedgpt_tpu_torch.ops import quantization as Q

    rows = MC_BATCH * VIT_TOKENS
    # patch and cls streams first, then odd counts, eval's two streams and a
    # training batch's two
    row_counts = (rows, MC_BATCH, 1, 4097, EVAL_BATCH * VIT_TOKENS, EVAL_BATCH,
                  TRAIN_BATCH * VIT_TOKENS, TRAIN_BATCH)
    ln_args, gelu_args = row_quant_args(torch, device, 0)

    records = {}
    records["cls_split_attention"] = check_cls_split(torch, device)
    records["ln_quant_rows"] = check_row_quant(
        torch, "ln_quant_rows", Q.ln_quant_rows,
        [(Q._ln_quant_rows_plain, *ROW_QUANT_TIGHT)],
        [(m, VIT_WIDTH) for m in row_counts], LN_QUANT_OPS_PER_ELEM, ln_args,
    )
    records["gelu_quant_rows"] = check_row_quant(
        torch, "gelu_quant_rows", Q.gelu_quant_rows,
        [(Q._gelu_quant_rows_as_plain, *ROW_QUANT_TIGHT),
         (Q._gelu_quant_rows_plain, *ROW_QUANT_EXACT_ERF)],
        [(m, VIT_MLP) for m in row_counts], GELU_QUANT_OPS_PER_ELEM, gelu_args,
    )
    records["flash_attention"] = check_flash(torch, device)
    records["cls_split_attention_scaled"] = check_cls_split_scaled(torch, device)
    records["noisy_tile_kernel"] = check_noise(torch, device)
    records["w8a8_gemm"] = phase_w8a8_gemm(torch, device)
    records["w8a8_epilogue"] = check_w8a8_epilogue(torch, device)
    records["int8_weight_matmul"] = check_int8_weight(torch, device)
    lone_row = check_attention_kv8(torch, device)
    records["attention_kv8"] = check_attention_kv8_tiled(torch, device)
    records["attention_kv8_prefill"] = check_attention_kv8_prefill(torch, device)
    records["attention_kv8_decode"] = check_attention_kv8_decode(torch, device)
    records["attention_kv8_decode"]["shapes"]["lone bf16 row, nothing written"] = lone_row
    for name, part in (("attention_kv8", "attention_kv8_kernel"),
                       ("attention_kv8_prefill", "kv8_prefill"),
                       ("attention_kv8_decode", "kv8_decode")):
        records[name]["sass_i2f"] = {
            fn: n for fn, n in records["int8_weight_matmul"]["sass_i2f"].items() if part in fn}
    records["quant_rows"] = check_quant_rows(torch, device)
    check_f32_instances(torch, device, records)
    records.update(phase_decoder_fusions(torch, device))
    records.update(phase_decoder_grads(torch, device))
    records.update(phase_train_kernels(torch, device))
    return records


KERNELS = [
    # name, source, TPU kernel replaced, the path whose run gives its launches
    ("cls_split_attention", "certifiedgpt_tpu_torch/csrc/cls_split_attention.cu",
     "certifiedgpt_tpu/ops/flash_attention.py:258", "certify flash_cls"),
    ("ln_quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:208", "certify flash_cls"),
    ("gelu_quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:136", "certify flash_cls"),
    ("flash_attention", "certifiedgpt_tpu_torch/csrc/flash_attention.cu",
     "certifiedgpt_tpu/ops/flash_attention.py:39", "certify flash_custom"),
    ("noisy_tile_kernel", "certifiedgpt_tpu_torch/csrc/noise.cu",
     "certifiedgpt_tpu/ops/noise.py:58", "noisy_tile kernel mode"),
    ("cls_split_attention_scaled", "certifiedgpt_tpu_torch/csrc/cls_split_attention.cu",
     "scripts/bench_cls_split_attention.py:35", "cls_split_attention_scaled"),
    # the ops that XLA fuses for the JAX package (no Pallas kernel there):
    # the W8A8 product with its rescale and bias (phase 21), and the rescale
    # alone, of the int32 sums that the row-parallel dense adds over ranks
    ("w8a8_gemm", "certifiedgpt_tpu_torch/csrc/w8a8_gemm.cu",
     "certifiedgpt_tpu/ops/quantization.py:68", "certify flash_cls"),
    ("w8a8_epilogue", "certifiedgpt_tpu_torch/csrc/w8a8_epilogue.cu",
     "certifiedgpt_tpu/ops/quantization.py:68", "row-parallel dense"),
    ("int8_weight_matmul", "certifiedgpt_tpu_torch/csrc/int8_weight_matmul.cu",
     "certifiedgpt_tpu/models/layers.py:61", "certify flash_cls"),
    # the tiled kernel: the f32 prefill's cache write and attention in one
    # launch (f32 configurations), bf16 at other head widths, lone rows at
    # other group sizes; its path is the f32 decoder's prefill (phase 18.1)
    ("attention_kv8", "certifiedgpt_tpu_torch/csrc/attention_kv8.cu",
     "certifiedgpt_tpu/ops/attention.py:76", "f32 decoder prefill"),
    # the prefill's cache write (two quantize_rows, four slice writes) and
    # attention in one launch, the JAX block's cached branch
    ("attention_kv8_prefill", "certifiedgpt_tpu_torch/csrc/attention_kv8_prefill.cu",
     "certifiedgpt_tpu/models/llama.py:243", "certify flash_cls"),
    ("quant_rows", "certifiedgpt_tpu_torch/csrc/row_quant.cu",
     "certifiedgpt_tpu/ops/quantization.py:52", "certify flash_cls"),
    # the decode step's cache write (two quantize_rows, four slice writes)
    # and attention in one launch, the JAX block's cached branch
    ("attention_kv8_decode", "certifiedgpt_tpu_torch/csrc/attention_kv8_decode.cu",
     "certifiedgpt_tpu/models/llama.py:243", "certify flash_cls"),
    # the decoder block's XLA-fused elementwise chains (phase 20): the
    # residual add + RMSNorm (+ the W8A8 input's quantize_rows), the rotary
    # of q and k, SiLU x up (+ the down_proj input's quantize_rows)
    ("add_rms_norm", "certifiedgpt_tpu_torch/csrc/elementwise.cu",
     "certifiedgpt_tpu/models/layers.py:110", "certify flash_cls"),
    ("rotary", "certifiedgpt_tpu_torch/csrc/elementwise.cu",
     "certifiedgpt_tpu/models/layers.py:150", "certify flash_cls"),
    ("silu_mul", "certifiedgpt_tpu_torch/csrc/elementwise.cu",
     "certifiedgpt_tpu/models/llama.py:284", "certify flash_cls"),
    # their backward in a train step (phase 23), where the JAX package's
    # autodiff differentiates the same chains and XLA fuses the backward;
    # their path is the W8A8 train step of phase 11.1
    ("add_rms_norm_grad", "certifiedgpt_tpu_torch/csrc/elementwise.cu",
     "certifiedgpt_tpu/models/layers.py:110", "train step"),
    ("rotary_grad", "certifiedgpt_tpu_torch/csrc/elementwise.cu",
     "certifiedgpt_tpu/models/layers.py:150", "train step"),
    ("silu_mul_grad", "certifiedgpt_tpu_torch/csrc/elementwise.cu",
     "certifiedgpt_tpu/models/llama.py:284", "train step"),
    # the train step's remaining XLA fusions (phase 24): the W8A8 product's
    # straight-through input gradient reading the int8 kernel (JAX's
    # _w8a8_bwd), and the training attention, forward and its two backward
    # kernels (multi_head_attention under the training mask, and its VJP)
    ("w8_grad_gemm", "certifiedgpt_tpu_torch/csrc/w8_grad_gemm.cu",
     "certifiedgpt_tpu/ops/quantization.py:102", "train step"),
    ("train_attention_fwd", "certifiedgpt_tpu_torch/csrc/train_attention.cu",
     "certifiedgpt_tpu/ops/attention.py:40", "train step"),
    ("train_attention_dq", "certifiedgpt_tpu_torch/csrc/train_attention.cu",
     "certifiedgpt_tpu/ops/attention.py:40", "train step"),
    ("train_attention_dkv", "certifiedgpt_tpu_torch/csrc/train_attention.cu",
     "certifiedgpt_tpu/ops/attention.py:40", "train step"),
]


def plus(*counts):
    """The sum of launch-count dicts, kernel by kernel."""
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


def times(counts, k):
    return {name: n * k for name, n in counts.items()}


# launches of the int8 ops (a W8A8 product is one launch of the GEMM kernel,
# its rescale and bias inside): an image batch through the ViT (the split-stream
# tower: its four W8A8 products a layer on each stream, the proj input's
# quantization on each; the flash block: its four products and the qkv, proj
# and fc1 inputs' quantization on its one stream); the prefill (seven W8A8
# products a layer, the q/k/v input quantized once for the three and the
# gate/up input once for the two, the o and down inputs; the k and v rows'
# cache write and the attention in one launch); a decode step (seven
# weight-only products a layer, the cache write and the attention in one
# launch); and a
# train step of the decoder (seven W8A8 products a layer; the q/k/v and
# gate/up inputs' codes from their norms, the down input's from silu_mul, so
# only the o input runs quantize_rows; the fused ops' forward and backward)
VIT_INT8 = {"flash_cls": {"w8a8_gemm": 8 * VIT_DEPTH, "quant_rows": 2 * VIT_DEPTH},
            "flash_custom": {"w8a8_gemm": 4 * VIT_DEPTH, "quant_rows": 3 * VIT_DEPTH}}
# the decoder's fused elementwise ops in a forward that autograd does not
# record (a prefill, a decode step, a validation batch): two norms a layer
# (the input norm adding the previous down_proj output, the post-attention
# norm adding the o_proj output) and the final one, one rotary (q and k)
# and one SiLU x up a layer
DECODER_FUSED = {"add_rms_norm": 2 * LLAMA_DEPTH + 1, "rotary": LLAMA_DEPTH,
                 "silu_mul": LLAMA_DEPTH}
# the prefill: the q/k/v and gate/up inputs' codes come from their norms,
# the down input's from silu_mul; only the o input runs quantize_rows
PREFILL_INT8 = plus({"w8a8_gemm": 7 * LLAMA_DEPTH, "quant_rows": LLAMA_DEPTH,
                     "attention_kv8_prefill": LLAMA_DEPTH}, DECODER_FUSED)
PER_DECODE_STEP = plus({"int8_weight_matmul": 7 * LLAMA_DEPTH,
                        "attention_kv8_decode": LLAMA_DEPTH}, DECODER_FUSED)
# the backward kernels of a train step: each fused op's once
DECODER_FUSED_GRAD = {"add_rms_norm_grad": 2 * LLAMA_DEPTH + 1, "rotary_grad": LLAMA_DEPTH,
                      "silu_mul_grad": LLAMA_DEPTH}
# the training attention (no cache), a forward launch a layer; its backward
# two launches (dq, then dk and dv)
TRAIN_ATTENTION = {"train_attention_fwd": LLAMA_DEPTH}
TRAIN_ATTENTION_GRAD = {"train_attention_dq": LLAMA_DEPTH, "train_attention_dkv": LLAMA_DEPTH}
TRAIN_DECODER = plus(DECODER_FUSED, DECODER_FUSED_GRAD, TRAIN_ATTENTION, TRAIN_ATTENTION_GRAD)
# the W8A8 products' straight-through input gradients: one launch each, the
# int8 kernel read in place of a dequantized copy
TRAIN_DECODER_INT8 = plus({"w8a8_gemm": 7 * LLAMA_DEPTH, "quant_rows": LLAMA_DEPTH,
                           "w8_grad_gemm": 7 * LLAMA_DEPTH}, TRAIN_DECODER)
# a validation batch's decoder (no autograd): the prefill's products and
# fused ops, the training attention's forward (no cache)
VAL_DECODER_INT8 = plus({"w8a8_gemm": 7 * LLAMA_DEPTH, "quant_rows": LLAMA_DEPTH},
                        DECODER_FUSED, TRAIN_ATTENTION)

# launches per certify chunk of each kernel under each ViT attention form:
# the split-stream tower runs the cls-split kernel once a layer and the two
# row-quant kernels on both streams (LN at the qkv and fc1 inputs, GELU at
# fc2); the flash block runs the flash kernel once a layer and the GELU
# kernel at fc2 on its one stream, and quantizes its qkv and fc1 inputs in
# plain PyTorch as the JAX package's block does
VIT_PER_CHUNK = {
    "flash_cls": {"cls_split_attention": VIT_DEPTH, "ln_quant_rows": 4 * VIT_DEPTH,
                  "gelu_quant_rows": 2 * VIT_DEPTH, "flash_attention": 0},
    "flash_custom": {"cls_split_attention": 0, "ln_quant_rows": 0,
                     "gelu_quant_rows": VIT_DEPTH, "flash_attention": VIT_DEPTH},
}
# a chunk (or an eval batch, or a caption): the ViT and the prefill; its
# decode steps add PER_DECODE_STEP each
PER_CHUNK = {form: plus(vit, VIT_INT8[form], PREFILL_INT8)
             for form, vit in VIT_PER_CHUNK.items()}
PER_CHUNK["flash"] = PER_CHUNK["flash_custom"]


def wrappers():
    """Each kernel's wrapper, which carries its launch counter."""
    from certifiedgpt_tpu_torch.ops.flash_attention import (
        cls_split_attention_parts,
        cls_split_attention_scaled,
        flash_attention,
    )
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q
    from certifiedgpt_tpu_torch.ops.attention import (
        decode_attention_kv8,
        multi_head_attention_kv8,
        prefill_attention_kv8,
    )
    from certifiedgpt_tpu_torch.ops import elementwise as E
    from certifiedgpt_tpu_torch.ops.noise import noisy_tile

    return {"cls_split_attention": cls_split_attention_parts,
            "ln_quant_rows": Q.ln_quant_rows, "gelu_quant_rows": Q.gelu_quant_rows,
            "flash_attention": flash_attention, "noisy_tile_kernel": noisy_tile,
            "cls_split_attention_scaled": cls_split_attention_scaled,
            "w8a8_gemm": Q.w8a8_product, "w8a8_epilogue": Q.w8a8_epilogue,
            "int8_weight_matmul": Q.int8_weight_forward,
            "attention_kv8": multi_head_attention_kv8, "quant_rows": Q.quantize_rows,
            "attention_kv8_prefill": prefill_attention_kv8,
            "attention_kv8_decode": decode_attention_kv8,
            "add_rms_norm": E.add_rms_norm, "rotary": E.rotary, "silu_mul": E.silu_mul,
            "add_rms_norm_grad": E.add_rms_norm_grad, "rotary_grad": E.rotary_grad,
            "silu_mul_grad": E.silu_mul_grad, "w8_grad_gemm": Q.w8_grad_gemm,
            "train_attention_fwd": A.train_attention_fwd,
            "train_attention_dq": A.train_attention_dq,
            "train_attention_dkv": A.train_attention_dkv}


def reset_counts():
    """Every kernel's launches, the plain cls query row's calls and the
    decode steps launched, to 0."""
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.ops.flash_attention import _cls_query_row

    for fn in wrappers().values():
        fn.launches = 0
    _cls_query_row.calls = 0
    M.generate.decode_steps = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def decode_steps() -> int:
    """Decode steps ``generate`` launched since ``reset_counts``."""
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    return M.generate.decode_steps


def check_counts(label, launches, per_chunk, chunks, steps=0):
    """Every kernel of the path launched ``per_chunk`` times a chunk plus
    ``PER_DECODE_STEP`` times each of the ``steps`` decode steps
    (``generate.decode_steps``, greedy, sampled and beam search alike), and
    no other kernel at all; the plain cls query row (the cls-split kernel
    computes that row itself) was never called."""
    from certifiedgpt_tpu_torch.ops.flash_attention import _cls_query_row

    if _cls_query_row.calls:
        fail(f"{label}: the plain cls query row ran {_cls_query_row.calls} times")
    for name, n in launches.items():
        base, per_step = per_chunk.get(name, 0) * chunks, PER_DECODE_STEP.get(name, 0)
        want = base + (per_step * steps if per_step else 0)
        if n != want:
            fail(f"{label}: kernel {name} launched {n} times, expected {want} "
                 f"({per_chunk.get(name, 0)} x {chunks} chunks + {per_step} x {steps} "
                 "decode steps)")
        if want and n <= 0:
            fail(f"{label}: kernel {name} was not launched")


# ----------------------------------------------------------------------
# phase 4: the main path
# ----------------------------------------------------------------------
def phase_main_path(torch, device, card):
    import numpy as np

    from certifiedgpt_tpu_torch.agents.certify import certify_item
    from certifiedgpt_tpu_torch.common.stages import StageClock
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    t0 = time.perf_counter()
    model = MiniGPT4Model.from_config(CERTIFY_MODEL_BLOCK, device)
    torch.cuda.synchronize()
    cfg = model.cfg
    log(
        f"[main] built full-width model (ViT depth {cfg.vit.depth}, attn_impl "
        f"{cfg.vit.attn_impl}, Q-Former {cfg.qformer.num_layers} layers, decoder "
        f"{cfg.llama.num_layers}x{cfg.llama.hidden_size}) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card"
    )
    image = np.random.RandomState(0).randn(*IMAGE_HWC).astype(np.float32)

    # warm-up chunk: allocator and cuBLAS heuristics, outside the counted run
    clock = StageClock(device)
    certify_item(model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with CardSampler() as card_state:
        t0 = time.perf_counter()
        row = certify_item(model, image, QUESTION, GT_ANSWERS, CLOCKED_RUN_CFG, index=0,
                           clock=clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_counts()
    steps = decode_steps()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    chunks = clock.counts.get("noise", 0)
    stages = stage_seconds(clock, wall)
    log(f"[main] certify row: {json.dumps(row)}")
    log(f"[main] wall {wall:.3f} s over {chunks} chunks of {MC_BATCH}; stage seconds "
        f"{json.dumps(stages)}; {card}")
    log(f"[main] decode steps {clock.counts.get('decode_step', 0)}; peak memory {peak_gb:.2f} GB; "
        f"card during the run: {card_state.summary()}")
    log(f"[main] launches {json.dumps(launches)}")
    check_counts("certify flash_cls", launches, PER_CHUNK["flash_cls"], chunks, steps)
    check_row(row, CLOCKED_RUN_CFG)
    prefill = prefill_costs(torch, model, device)
    decode_costs(torch, model, device)
    step = generate_step_costs(torch, model)
    check_outputs(torch, model, device)
    phase_profile(torch, model, image)
    return model, image, launches, {"wall_seconds": wall, "stage_seconds": stages,
                                    "chunks": chunks, "peak_gb": peak_gb, "row": row,
                                    "prefill": prefill, "generate_step": step}


def stage_seconds(clock, wall):
    stages = {k: round(v, 4) for k, v in clock.seconds.items()}
    stages["other_host"] = round(wall - sum(clock.seconds.values()), 4)
    return stages


def check_row(row, run_cfg):
    required = {"index", "question_id", "label", "answer", "radius", "correct",
                "abstain", "seconds", "sigma", "n0", "n", "draws"}
    if set(row) != required:
        fail(f"certify row keys {sorted(row)} != {sorted(required)}")
    if not (isinstance(row["label"], int) and math.isfinite(row["radius"]) and row["radius"] >= 0):
        fail(f"malformed certify row {row}")
    budget = run_cfg["certify_n0"] + run_cfg["certify_n"]
    if row["abstain"] != (row["label"] == -1) or not 0 < row["draws"] <= budget:
        fail(f"inconsistent certify row {row}")


def prefill_costs(torch, model, device):
    """A certify chunk's prefill (the full-width decoder over 96 prompts of
    96 positions into a 106-slot int8 cache), as the port runs it and with
    ``prefill_attention_kv8`` replaced by the sequence it took the place of
    (two ``quantize_rows``, four slice writes, ``multi_head_attention_kv8``),
    in turns in one process: device operations (``torch.profiler``) and
    eager milliseconds; the kernel's launch saves 6 operations a layer."""
    from unittest import mock

    from certifiedgpt_tpu_torch.models.llama import init_kv_cache, llama_apply
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import cuda_kernels
    from certifiedgpt_tpu_torch.ops import quantization as Q

    params = model.params["llama"]
    cfg = model.cfg.llama
    s = RUN_CFG["seq_len"]
    cache = init_kv_cache(cfg, MC_BATCH, CACHE_LEN, device)
    mask = torch.ones((MC_BATCH, CACHE_LEN), dtype=torch.int32, device=device)
    g = torch.Generator(device=device).manual_seed(13)
    x = torch.randn((MC_BATCH, s, cfg.hidden_size), generator=g, device=device).to(torch.bfloat16)
    pos = torch.arange(s, device=device)[None].expand(MC_BATCH, s)

    def prefill():
        llama_apply(params, cfg, x, mask, pos, cache, 0)

    def replaced(q, k, v, c, offset, m=None, scale=None):
        kq, ks = Q.quantize_rows(k)
        vq, vs = Q.quantize_rows(v)
        at = slice(offset, offset + k.shape[1])
        c["k"][:, at] = kq
        c["v"][:, at] = vq
        c["k_scale"][:, at] = ks
        c["v_scale"][:, at] = vs
        return A.multi_head_attention_kv8(q, c["k"], c["k_scale"], c["v"], c["v_scale"], m, scale)

    runs = {}
    for turn in ("kernel", "replaced", "chains", "pair", "pair", "chains", "replaced", "kernel"):
        patches = {"replaced": [mock.patch.object(A, "prefill_attention_kv8", replaced)],
                   "chains": chain_versions(), "pair": pair_versions(torch)}.get(turn, [])
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            ms = cuda_ms(torch, prefill, iters=3, warmup=1)
            _, ops = cuda_kernels.traced_launches(prefill)
        runs.setdefault(turn, []).append((ops, ms))
    fewer = runs["replaced"][0][0] - runs["kernel"][0][0]
    log(f"[main] a certify chunk's prefill: {runs['kernel'][0][0]} device operations with the "
        f"prefill's kernel, {runs['replaced'][0][0]} with the sequence it replaced ({fewer} "
        f"fewer; each form's operations in its two turns "
        f"{json.dumps({k: [r[0] for r in v] for k, v in runs.items()})}; eager ms in turns: kernel {runs['kernel'][0][1]:.3f}, replaced "
        f"{runs['replaced'][0][1]:.3f}, replaced {runs['replaced'][1][1]:.3f}, kernel "
        f"{runs['kernel'][1][1]:.3f})")
    log(f"[main] a certify chunk's prefill: {runs['kernel'][0][0]} device operations with the "
        f"decoder's fused elementwise kernels, {runs['chains'][0][0]} with the chains they "
        f"replaced (phase 20; eager ms in turns: kernels {runs['kernel'][0][1]:.3f}, chains "
        f"{runs['chains'][0][1]:.3f}, chains {runs['chains'][1][1]:.3f}, kernels "
        f"{runs['kernel'][1][1]:.3f})")
    log(f"[main] a certify chunk's prefill: {runs['kernel'][0][0]} device operations with the "
        f"W8A8 GEMM kernel, {runs['pair'][0][0]} with the pair it replaced (_int_mm, then "
        f"w8a8_epilogue: {runs['pair'][0][0] - runs['kernel'][0][0]} more for its "
        f"{7 * LLAMA_DEPTH} products; phase 21; eager ms in turns: kernel "
        f"{runs['kernel'][0][1]:.3f}, pair {runs['pair'][0][1]:.3f}, pair "
        f"{runs['pair'][1][1]:.3f}, kernel {runs['kernel'][1][1]:.3f})")
    if runs["pair"][0][0] <= runs["kernel"][0][0]:
        fail("the prefill with the W8A8 GEMM kernel issues no fewer device operations than "
             "with the pair it replaced")
    if fewer != 6 * LLAMA_DEPTH:
        fail(f"the prefill's kernel saved {fewer} device operations a chunk, expected "
             f"{6 * LLAMA_DEPTH}")
    del cache, x
    torch.cuda.empty_cache()
    return {"ops": runs["kernel"][0][0], "replaced_ops": runs["replaced"][0][0],
            "chains_ops": runs["chains"][0][0], "pair_ops": runs["pair"][0][0],
            "pair_ms": [r[1] for r in runs["pair"]], "ms": [r[1] for r in runs["kernel"]],
            "replaced_ms": [r[1] for r in runs["replaced"]],
            "chains_ms": [r[1] for r in runs["chains"]]}


def decode_costs(torch, model, device):
    """What the decode costs per step: one whole decode step at the certify
    batch against the bound for reading its int8 weights once; and whether
    the host or the card sets a step's pace: the host's seconds to launch one
    step (from an idle card, not waiting for it), and the same step
    replayed from a CUDA graph (the card's time without the host's
    launches); and the host's seconds to launch the step behind a spin that
    holds the card for ``SPIN_MS``: near the spin's length if the step's
    launches fill the launch queue (the host then waits for the card), near
    the idle card's figure if they do not (the time is the host's own)."""
    from certifiedgpt_tpu_torch.models.llama import init_kv_cache, llama_apply
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    params = model.params["llama"]
    cfg = model.cfg.llama
    mods = [m for m, leaves in params["layers"].items() if "kernel_q" in leaves]

    total = RUN_CFG["seq_len"] + RUN_CFG["max_new_tokens"]
    cache = init_kv_cache(cfg, MC_BATCH, total, device)
    mask = torch.ones((MC_BATCH, total), dtype=torch.int32, device=device)
    x = torch.zeros((MC_BATCH, 1, cfg.hidden_size), dtype=torch.bfloat16, device=device)
    pos = torch.full((MC_BATCH, 1), RUN_CFG["seq_len"], dtype=torch.int32, device=device)

    def step():
        llama_apply(params, cfg, x, mask, pos, cache, RUN_CFG["seq_len"])

    step_ms = cuda_ms(torch, step, iters=3, warmup=1)
    wbytes = sum(params["layers"][m]["kernel_q"].numel() for m in mods)
    log(f"[main] decode step {step_ms:.2f} ms at batch {MC_BATCH}; bound for reading its "
        f"{wbytes / 1e9:.2f} G int8 decoder weights once: "
        f"{wbytes / PEAK_BYTES_PER_S * 1e3:.2f} ms")
    host_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    # the same launch behind a spin that holds the card: a step whose
    # launches overflow the launch queue makes the host wait for the spin
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    spin_cycles = int(10 ** 8 * SPIN_MS / start.elapsed_time(end))
    behind_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin_cycles)
        t0 = time.perf_counter()
        step()
        behind_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    _, device_ops = cuda_kernels.traced_launches(step)
    with contextlib.ExitStack() as stack:
        for patch in chain_versions():
            stack.enter_context(patch)
        chains_ms = cuda_ms(torch, step, iters=3, warmup=1)
        _, chains_ops = cuda_kernels.traced_launches(step)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # capture wants its warm-up off the default stream
        step()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        step()
    graph_ms = cuda_ms(torch, graph.replay, iters=5, warmup=1)
    del graph
    log(
        f"[main] decode step: the host launches it in {min(host_ms):.2f} ms (of 3: "
        f"{', '.join(f'{t:.2f}' for t in host_ms)}), the card runs it from a CUDA graph in "
        f"{graph_ms:.2f} ms, eager {step_ms:.2f} ms"
    )
    verdict = ("the launch queue filled: the host waited for the card"
               if min(behind_ms) > SPIN_MS / 2 else
               "the queue never filled: the launch time is the host's own")
    log(
        f"[main] decode step behind a {SPIN_MS:.0f} ms spin of the card: the host launches it "
        f"in {min(behind_ms):.2f} ms (of 3: {', '.join(f'{t:.2f}' for t in behind_ms)}), "
        f"from an idle card {min(host_ms):.2f} ms; {device_ops} device operations a step "
        f"(1950 in the run before the decode's kernel wrote the cache itself); {verdict}"
    )
    log(f"[main] decode step with the decoder's fused elementwise kernels: {device_ops} device "
        f"operations, eager {step_ms:.2f} ms; with the chains they replaced (phase 20): "
        f"{chains_ops} device operations, eager {chains_ms:.2f} ms")


def generate_step_costs(torch, model):
    """The certify chunk's decode step as ``generate`` runs it: replayed
    from the CUDA graph that the warm-up's chunk captured (the embedding,
    the 32 layers at the device slot, the lm_head, the choice and the
    output's column), its device ms a replay and the host's ms to launch
    a replay from an idle card, beside the same step run eagerly (device
    ms over back-to-back calls, and the host's ms). The state is put back
    to step 0 before each replay (a replay writes cache slot s + t)."""
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    graphs = M._decode_graphs(model.params)
    key, st = next((k, v) for k, v in graphs.states.items() if v.graph is not None)
    knobs = key[4]
    kept = [x.clone() for x in st.small()]

    def reset():
        for x, was in zip(st.small(), kept):
            x.copy_(was)

    def timed(fn, iters):
        ms = []
        for _ in range(iters):
            reset()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return min(ms)

    def host(fn):
        ms = []
        for _ in range(3):
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return min(ms)

    def eager():
        M._decode_step(model.params, model.cfg, st, knobs, None)

    replay_ms, replay_host = timed(st.graph.replay, 5), host(st.graph.replay)
    eager_ms, eager_host = timed(eager, 3), host(eager)
    reset()
    log(f"[main] generate's decode step at batch {st.token.shape[0]} (the captured step: "
        f"embedding, {model.cfg.llama.num_layers} layers at the device slot, lm_head, the "
        f"choice, the output column): {replay_ms:.3f} ms a replay on the card, the host "
        f"launches a replay in {replay_host:.3f} ms; the same step eager {eager_ms:.3f} ms "
        f"(the host launches it in {eager_host:.3f} ms); {torch.cuda.get_device_name(0)}")
    return {"replay_ms": replay_ms, "replay_host_ms": replay_host, "eager_ms": eager_ms,
            "eager_host_ms": eager_host}


def check_outputs(torch, model, device):
    """Correctness of the full-width outputs on the card: the projected
    image tokens are finite and of the expected shape, and the whole tower
    run through the kernels agrees with the same tower run through the
    kernels' plain versions (which the CPU tests hold against the JAX
    package) on a few images. Greedy tokens are in the vocabulary."""
    from unittest import mock

    import numpy as np

    from certifiedgpt_tpu_torch.models import eva_vit as V
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.ops import flash_attention as FA
    from certifiedgpt_tpu_torch.ops import quantization as Q

    cfg = model.cfg
    params = model.params
    rng = np.random.RandomState(1)
    # 8 images: the cls stream's W8A8 products are 8 rows, one partial row
    # tile of the GEMM
    num = 8
    images = torch.from_numpy(rng.randn(num, 448, 448, 3).astype(np.float32)).to(device)
    feats = M.eva_vit_apply(params["vit"], cfg.vit, images)
    with mock.patch.object(V, "cls_split_attention_parts", FA._cls_split_attention_plain), \
            mock.patch.object(Q, "ln_quant_rows", Q._ln_quant_rows_plain), \
            mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_plain), \
            mock.patch.object(Q, "quantize_rows", Q._quantize_rows_plain), \
            mock.patch.object(Q, "w8a8_product", Q._w8a8_product_plain):
        feats_plain = M.eva_vit_apply(params["vit"], cfg.vit, images)
    rel = float((feats.float() - feats_plain.float()).norm() / feats_plain.float().norm())
    log(f"[check] ViT tokens {tuple(feats.shape)}, kernels vs plain versions on {num} images: "
        f"relative error {rel:.3e}")
    if tuple(feats.shape) != (num, cfg.vit.seq_len, cfg.vit.embed_dim) or not (rel < 5e-2):
        fail("the ViT through the kernels disagrees with its plain path")
    out = M.encode_img(params, cfg, images)
    expected = (num, cfg.num_img_tokens, cfg.llama.hidden_size)
    if tuple(out.shape) != expected or not bool(torch.isfinite(out).all()):
        fail(f"encode_img output {tuple(out.shape)} is not finite or not {expected}")
    prompt = {k: torch.zeros((num, 40), dtype=torch.long, device=device)
              for k in ("input_ids", "attention_mask")}
    prompt["attention_mask"] += 1
    prompt["img_pos"] = torch.full((num,), 1, dtype=torch.long, device=device)
    tokens = M.generate_greedy(params, cfg, dict(prompt, image=images), 4,
                               model.tokenizer.eos_token_id)
    if tokens.shape != (num, 4) or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.llama.vocab_size:
        fail(f"greedy tokens out of range: {tokens.tolist()}")
    log(f"[check] encode_img {tuple(out.shape)} finite; greedy tokens {tokens[:2].tolist()} ...")


def phase_profile(torch, model, image):
    """The warm-up's certification (one chunk each way) timed once more
    unprofiled, then once under ``torch.profiler``: device time summed by
    kernel group and the top kernels, each as a share of the profiled wall.
    The share of the summed kernel time in the wall is the device's busy
    share (kernels run one at a time on the one stream)."""
    from certifiedgpt_tpu_torch.agents.certify import certify_item
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    def run():
        t0 = time.perf_counter()
        certify_item(model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain_wall = run()
    with cuda_kernels.device_trace(cpu=True) as prof:
        wall = run()
    kernels = [e for e in cuda_kernels.device_events(prof.key_averages())
               if e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"[profile] two chunks of {MC_BATCH}: wall {plain_wall:.4f} s unprofiled, "
        f"{wall:.4f} s profiled; summed kernel time {busy:.4f} s = "
        f"{100 * busy / wall:.1f} % of the profiled wall")
    if busy <= 0:
        fail("the profiler saw no device time")
    groups = {}
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other elementwise / copy")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e6
    for group, sec in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {group:26s} {sec:8.4f} s {100 * sec / wall:6.2f} % of wall")
    for e in kernels[:12]:
        sec = e.self_device_time_total / 1e6
        log(f"[profile] {sec:8.4f} s {100 * sec / wall:6.2f} % {e.count:6d} calls  {e.key[:100]}")
    # per-call device time of the row-quant kernels by shape: the split-stream
    # tower calls each of them on the patch rows and then on the cls rows
    for name in ("ln_quant_kernel", "gelu_quant_kernel"):
        calls = sorted((e for e in cuda_kernels.device_events(prof.events())
                        if name in e.name),
                       key=lambda e: e.time_range.start)
        patch = [e.time_range.elapsed_us() / 1e3 for e in calls[0::2]]
        cls = [e.time_range.elapsed_us() / 1e3 for e in calls[1::2]]
        if not cls or len(patch) != len(cls):
            fail(f"the profile holds {len(calls)} calls of {name}, not pairs")
        log(f"[profile] {name}: {len(patch)} calls at [{MC_BATCH * VIT_TOKENS}, K] "
            f"{sum(patch) / len(patch):.4f} ms each (min {min(patch):.4f}), {len(cls)} calls at "
            f"[{MC_BATCH}, K] {sum(cls) / len(cls):.4f} ms each (max {max(cls):.4f})")


# ----------------------------------------------------------------------
# phase 6: the flash attention forms of the ViT
# ----------------------------------------------------------------------
def phase_forms(torch, model, image, device):
    """The main path's model under ``vit_attn_impl`` flash_custom and flash:
    configs parsed from the certify model block with the form changed,
    around the same parameter tensors. Their towers agree with the
    flash_cls tower on 8 images; each form certifies the smoke image over
    two chunks (after one warm-up certification), beside flash_cls, with
    the launches counted. Returns the flash_custom run's launches."""
    import numpy as np

    from certifiedgpt_tpu_torch.agents.certify import certify_item
    from certifiedgpt_tpu_torch.common.stages import StageClock
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, config_from_block

    models = {"flash_cls": model}
    for form in FLASH_FORMS:
        cfg = config_from_block(dict(CERTIFY_MODEL_BLOCK, vit_attn_impl=form))
        if cfg.vit.attn_impl != form:
            fail(f"config_from_block gave attn_impl {cfg.vit.attn_impl!r} for {form!r}")
        models[form] = MiniGPT4Model(cfg, model.params, model.tokenizer)

    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(8, *IMAGE_HWC).astype(np.float32)).to(device)
    vit = model.params["vit"]
    feats_cls = M.eva_vit_apply(vit, model.cfg.vit, images).float()
    for form in FLASH_FORMS:
        feats = M.eva_vit_apply(vit, models[form].cfg.vit, images).float()
        rel = float((feats - feats_cls).norm() / feats_cls.norm())
        log(f"[forms] ViT tokens under {form} {tuple(feats.shape)} vs flash_cls on 8 images: "
            f"relative error {rel:.3e}")
        if feats.shape != feats_cls.shape or not bool(torch.isfinite(feats).all()) \
                or not rel < 5e-2:
            fail(f"the {form} tower disagrees with the flash_cls tower")
        del feats
    del images, feats_cls
    torch.cuda.empty_cache()

    counted = {}
    for form, form_model in models.items():
        certify_item(form_model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG, index=0)
        clock = StageClock(device)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = certify_item(form_model, image, QUESTION, GT_ANSWERS, TWO_CHUNK_RUN_CFG,
                           index=0, clock=clock)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        steps = decode_steps()
        chunks = clock.counts.get("noise", 0)
        vit_per_chunk = clock.seconds.get("vit", 0.0) / max(chunks, 1)
        log(f"[forms] certify under {form}: row {json.dumps(row)}")
        log(f"[forms] certify under {form}: wall {wall:.4f} s over {chunks} chunks, ViT "
            f"{vit_per_chunk:.4f} s per chunk; stage seconds "
            f"{json.dumps(stage_seconds(clock, wall))}; launches {json.dumps(launches)}")
        check_row(row, TWO_CHUNK_RUN_CFG)
        check_counts(f"certify {form}", launches, PER_CHUNK[form], chunks, steps)
        counted[form] = launches
    return counted["flash_custom"]


# ----------------------------------------------------------------------
# phase 7: the kernels' own entry points
# ----------------------------------------------------------------------
def phase_entries(torch, device):
    """``noisy_tile``'s kernel mode and ``cls_split_attention_scaled``, which
    no certify path calls (as in the JAX package), each driven once through
    its entry at the main path's shapes, its launches counted; and
    ``multi_head_attention_kv8`` of a lone query row at the certify batch,
    which the decoder does not call: one launch of the decode kernel,
    nothing written."""
    import numpy as np

    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import flash_attention as FA
    from certifiedgpt_tpu_torch.ops.noise import noisy_tile

    x = torch.from_numpy(np.random.RandomState(0).randn(*IMAGE_HWC).astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(11)
    g = torch.Generator(device=device).manual_seed(12)
    d = VIT_HEAD_DIM
    qkv = [torch.randn((MC_BATCH, VIT_HEADS, VIT_SEQ, d), generator=g, device=device)
           .to(torch.bfloat16) for _ in range(3)]
    row = kv8_case(torch, device, g, MC_BATCH, 1, LLAMA_HEADS, LLAMA_HEADS, CACHE_LEN,
                   CACHE_LEN - 2)
    torch.cuda.synchronize()
    counted = {}
    for name, kernel, run, shape in (
        ("noisy_tile_kernel", "noisy_tile_kernel",
         lambda: noisy_tile(x, MC_BATCH, RUN_CFG["noise_level"], gen, use_kernel=True),
         (MC_BATCH,) + IMAGE_HWC),
        ("cls_split_attention_scaled", "cls_split_attention_scaled",
         lambda: FA.cls_split_attention_scaled(*qkv, d), (MC_BATCH, VIT_HEADS, VIT_SEQ, d)),
        ("lone kv8 row", "attention_kv8_decode", lambda: A.multi_head_attention_kv8(*row),
         (MC_BATCH, 1, LLAMA_HEADS, LLAMA_HEAD_DIM)),
    ):
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"[entry] {name}: output {tuple(out.shape)}; launches {json.dumps(launches)}")
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            fail(f"{name}: output {tuple(out.shape)} is not finite or not {shape}")
        check_counts(name, launches, {kernel: 1}, 1)
        counted[name] = launches[kernel]
    counted["w8a8_epilogue"] = row_parallel_entry(torch, device)
    return counted


def row_parallel_entry(torch, device):
    """The row-parallel dense (``parallel/tensor_parallel.py``: the o_proj
    and down_proj of a decoder split over a model group) of the prefill's
    down_proj at the certify prefill's rows, through an NCCL group of one
    rank (the one card): its W8A8 path sums each rank's int32 products
    (``int8_accumulate``, the GEMM kernel's int32 instance) over the group,
    then rescales them (``w8a8_epilogue``). One launch of each, no other
    kernel (its rows' quantization takes the MAX over the group between its
    two passes, in plain PyTorch), and the output bit for bit the one-rank
    product's (``w8a8_matmul``). Returns the epilogue's launches."""
    import tempfile

    import torch.distributed as dist

    from certifiedgpt_tpu_torch.ops import quantization as Q
    from certifiedgpt_tpu_torch.parallel import tensor_parallel as TP
    from certifiedgpt_tpu_torch.parallel.mesh import make_mesh, set_active_mesh

    g = torch.Generator(device=device).manual_seed(16)
    x = torch.randn((PREFILL_ROWS, LLAMA_MLP), generator=g, device=device).to(torch.bfloat16)
    params = Q.quantize_kernel(torch.randn((LLAMA_MLP, LLAMA_WIDTH), generator=g,
                                           device=device) * 0.01)
    params["kernel_q"] = Q.int8_kernel_layout(params["kernel_q"])
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
        try:
            mesh = make_mesh(n_model=1)
            torch.cuda.synchronize()
            reset_counts()
            out = TP.row_parallel_dense(params, x, mesh, act_quant=True)
            torch.cuda.synchronize()
            launches = read_counts()
        finally:
            set_active_mesh(None)
            dist.destroy_process_group()
    want = Q.w8a8_matmul(x, params["kernel_q"], params["scale"])
    off = bits_unequal(torch, out, want)
    log(f"[entry] row-parallel dense [{PREFILL_ROWS}, {LLAMA_MLP}] x [{LLAMA_MLP}, "
        f"{LLAMA_WIDTH}] (NCCL, one rank): {off} outputs not bit-identical to the one-rank "
        f"product; launches {json.dumps(launches)}")
    if off or out.shape != want.shape:
        fail("the row-parallel dense disagrees with the one-rank W8A8 product")
    check_counts("row-parallel dense", launches, {"w8a8_gemm": 1, "w8a8_epilogue": 1}, 1)
    return launches["w8a8_epilogue"]


# ----------------------------------------------------------------------
# phase 9.1 and 9.2: the look-ahead window and the early exit
# ----------------------------------------------------------------------
def phase_lookahead(torch, model, image, card, main_summary):
    """9.1: ``certify_item`` on phase 4's model and image with no clock, at
    (dispatch_window, early_exit) in ``LOOKAHEAD_RUNS``' order, one
    process: wall and decode steps launched per chunk, peak memory; the
    labels of every draw and the rows must be identical across the runs,
    and window 4's peak within phase 4's plus three noisy-image buffers.
    9.2: one chunk of the serial and one of the mixed pipeline dispatched,
    from the noise draw to the tokens' event, under
    ``torch.cuda.set_sync_debug_mode("error")``. Returns the 9.1 table."""
    from unittest import mock

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    make_sample_fn = A.make_sample_fn
    drawn = []

    def recording(*args, **kwargs):
        fn = make_sample_fn(*args, **kwargs)

        def sample_fn(*a, **k):
            labels = fn(*a, **k)
            drawn[-1].append(labels.tolist())
            return labels

        return sample_fn

    chunks = -(-LOOKAHEAD_RUN_CFG["certify_n0"] // MC_BATCH) \
        - (-LOOKAHEAD_RUN_CFG["certify_n"] // MC_BATCH)
    # phase 4's peak and three more chunks' noisy images, [96, 448, 448, 3] f32
    limit = main_summary["peak_gb"] + 3 * MC_BATCH * math.prod(IMAGE_HWC) * 4 / 1e9
    table, first = [], None
    with mock.patch.object(A, "make_sample_fn", recording):
        for window, early in LOOKAHEAD_RUNS:
            run_cfg = dict(LOOKAHEAD_RUN_CFG, dispatch_window=window, early_exit=early)
            drawn.append([])
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            M.generate.decode_steps = 0
            t0 = time.perf_counter()
            row = A.certify_item(model, image, QUESTION, GT_ANSWERS, run_cfg, index=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            steps = M.generate.decode_steps / chunks
            entry = {"window": window, "early_exit": early, "s_per_chunk": wall / chunks,
                     "decode_steps_per_chunk": steps, "peak_gb": peak}
            table.append(entry)
            log(f"[lookahead] window {window}, early_exit {early}: {wall / chunks:.4f} s a chunk "
                f"over {chunks} chunks, {steps:g} decode steps launched a chunk, peak memory "
                f"{peak:.2f} GB; {card}")
            check_row(row, run_cfg)
            key = ({k: v for k, v in row.items() if k != "seconds"}, drawn[-1])
            if first is None:
                first = key
            elif key != first:
                fail(f"window {window}, early_exit {early}: labels or row differ from the "
                     f"first run's ({json.dumps(key[0])} vs {json.dumps(first[0])})")
            if window > 1 and peak > limit:
                fail(f"window {window}: peak memory {peak:.2f} GB over phase 4's "
                     f"{main_summary['peak_gb']:.2f} GB plus three noisy-image buffers")
    if sum(len(labels) for labels in first[1]) != LOOKAHEAD_RUN_CFG["certify_n0"] + \
            LOOKAHEAD_RUN_CFG["certify_n"]:
        fail(f"phase 9.1 drew {[len(x) for x in first[1]]} labels, not the whole budget")
    log(f"[lookahead] table {json.dumps(table)}")
    check_no_sync(torch, model, image, card)
    check_early_exit_fires(torch, model.device, card)
    return table


def check_no_sync(torch, model, image, card):
    """Phase 9.2: dispatching a chunk, from the noise draw to the event
    behind its tokens' copy, never makes PyTorch wait for the card: the
    serial pipeline (``make_noisy_generate_fn``, early exit on) and the
    mixed one (``make_mixed_generate_fn``, with the uploads of its banks and
    row slots) under ``set_sync_debug_mode("error")``."""
    import numpy as np

    from certifiedgpt_tpu_torch.data.loader import HostCopy, upload
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.smoothing.classifier import chunk_seed, make_noisy_generate_fn
    from certifiedgpt_tpu_torch.smoothing.continuous import make_mixed_generate_fn

    device = model.device
    seq_len, steps, sigma = RUN_CFG["seq_len"], RUN_CFG["max_new_tokens"], RUN_CFG["noise_level"]
    prompt = build_gen_batch(model.tokenizer, [QUESTION],
                             BatchSpec(seq_len=seq_len, num_img_tokens=model.cfg.num_img_tokens))
    serial = make_noisy_generate_fn(model, sigma, MC_BATCH, steps, seq_len=seq_len,
                                    early_exit=True)
    slots = 8
    mixed = make_mixed_generate_fn(model, MC_BATCH, steps, slots, seq_len=seq_len,
                                   early_exit=True)
    x = upload(image, device)
    p_ids, p_am, p_pos = (upload(prompt[k], device).long()
                          for k in ("input_ids", "attention_mask", "img_pos"))
    bank = x.unsqueeze(0).repeat(slots, 1, 1, 1)
    banks = [np.repeat(prompt[k].astype(np.int64), slots, 0)
             for k in ("input_ids", "attention_mask", "img_pos")]
    rows = np.arange(MC_BATCH, dtype=np.int64) % slots

    def dispatch_serial():
        g = torch.Generator(device=device)
        g.manual_seed(chunk_seed(42, 0))
        return HostCopy(serial(x, p_ids, p_am, p_pos, g))

    def dispatch_mixed():
        g = torch.Generator(device=device)
        g.manual_seed(chunk_seed(42, 0))
        return HostCopy(mixed(bank, *(upload(b, device) for b in banks), upload(rows, device),
                              g, sigma))

    for name, dispatch in (("serial", dispatch_serial), ("mixed", dispatch_mixed)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = dispatch()
        except RuntimeError as exc:
            fail(f"phase 9.2: dispatching a {name} chunk made the host wait for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        queued = time.perf_counter() - t0
        tokens = pending.numpy()
        wall = time.perf_counter() - t0
        if tokens.shape != (MC_BATCH, steps) or tokens.min() < 0 \
                or tokens.max() >= model.cfg.llama.vocab_size:
            fail(f"phase 9.2: the {name} chunk's tokens are malformed: {tokens.shape}")
        log(f"[nosync] a {name} chunk dispatched without a sync (set_sync_debug_mode "
            f"'error'): queued in {queued:.4f} s, tokens on the host after {wall:.4f} s; {card}")


def chain_model(torch, device):
    """Phase 9.2's tiny model whose decoder weights send each row's last
    prompt token along a chain to EOS (``EXIT_CHAINS``), and its batch of
    ``EXIT_ROWS`` rows, which end at different steps."""
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    eos = 2
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, device)
    llama = model.params["llama"]
    for name in ("o_proj", "down_proj"):  # attention and MLP add nothing
        for leaf in llama["layers"][name].values():
            leaf.zero_()
    emb = llama["embed_tokens"]["embedding"]
    d = emb.shape[1]
    emb.copy_(torch.eye(d, device=device)[torch.arange(emb.shape[0], device=device) % d])
    head = llama["lm_head"]["kernel"]  # each one-hot to its successor
    head.copy_(torch.eye(d, head.shape[1], device=device))
    for first, chain in EXIT_CHAINS:
        seq = (first, *chain, eos)
        for a, b in zip(seq, seq[1:]):
            head[a, a] = 0.0
            head[a, b] = 1.0
    if llama["lm_head"].get("bias") is not None:
        llama["lm_head"]["bias"].zero_()
    llama["norm"]["scale"].fill_(1.0)
    seq_len, img = 40, model.cfg.vit.img_size
    ids = torch.full((len(EXIT_ROWS), seq_len), 5, dtype=torch.long, device=device)
    ids[:, -1] = torch.tensor([EXIT_CHAINS[r][0] for r in EXIT_ROWS], device=device)
    batch = {"image": torch.randn((len(EXIT_ROWS), img, img, 3), device=device),
             "input_ids": ids, "attention_mask": torch.ones_like(ids),
             "img_pos": torch.full((len(EXIT_ROWS),), 2, dtype=torch.long, device=device)}
    return model, batch


def check_early_exit_fires(torch, device, card):
    """Phase 9.2, the early exit firing on the card: on ``chain_model``,
    with the exit on, the tokens equal the full loop's (and the chains'),
    the host launched at least the steps until the last EOS and fewer than
    the full loop's, and neither call of ``generate`` made the host wait for
    the card."""
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    eos, pad = 2, 0
    model, batch = chain_model(torch, device)
    rows = EXIT_ROWS
    want = [list(EXIT_CHAINS[r][1]) + [eos] for r in rows]
    want = [t + [pad] * (EXIT_STEPS - len(t)) for t in want]
    longest = max(len(t) for t in (EXIT_CHAINS[r][1] for r in rows)) + 1
    M.generate(model.params, model.cfg, batch, EXIT_STEPS, eos, pad)  # warm-up
    outs, launched = {}, {}
    for early in (False, True):
        M.generate.decode_steps = 0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = M.generate(model.params, model.cfg, batch, EXIT_STEPS, eos, pad,
                             early_exit=early)
        except RuntimeError as exc:
            fail(f"phase 9.2: generate (early_exit {early}) made the host wait for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        outs[early] = out.cpu().tolist()
        launched[early] = M.generate.decode_steps
    if outs[True] != outs[False] or outs[False] != want:
        fail(f"phase 9.2: early exit tokens {outs[True]} differ from the full loop's "
             f"{outs[False]} or the chains' {want}")
    if launched[False] != EXIT_STEPS - 1 or not longest <= launched[True] < EXIT_STEPS - 1:
        fail(f"phase 9.2: {launched[True]} decode steps launched with the exit firing and "
             f"{launched[False]} without; want {longest} to {EXIT_STEPS - 2}, and "
             f"{EXIT_STEPS - 1}")
    log(f"[nosync] early exit firing (tiny model, weights chain tokens to EOS; the last row "
        f"done after {longest} steps): {launched[True]} decode steps launched, "
        f"{launched[False]} without the exit; tokens equal to the full loop's; no sync "
        f"(set_sync_debug_mode 'error'); {card}")


# ----------------------------------------------------------------------
# phase 19: the decode step replayed from a CUDA graph, against the eager step
# ----------------------------------------------------------------------
# phase 4's peak device memory with the decode launched eagerly, a fresh KV
# cache a chunk (PERF.md section 5; H100 80GB HBM3, 700 W)
EAGER_DECODE_PEAK_GB = 14.63
# 19(b): the EOS bias makes every row stop by this token at the latest
EXIT_BY_TOKEN = 4


def phase19_chunk(torch, model, image, seed: int):
    """A certify chunk's batch: ``MC_BATCH`` noisy copies of the image
    (sigma 0.5, seeded) and the certify prompt."""
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.ops.noise import noisy_tile

    device = model.device
    prompt = build_gen_batch(model.tokenizer, [QUESTION],
                             BatchSpec(seq_len=RUN_CFG["seq_len"],
                                       num_img_tokens=model.cfg.num_img_tokens))
    batch = {k: torch.from_numpy(v).long().to(device).expand(MC_BATCH, -1)
             if v.ndim == 2 else torch.from_numpy(v).long().to(device).expand(MC_BATCH)
             for k, v in prompt.items()}
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    x = torch.from_numpy(image).to(device)
    batch["image"] = noisy_tile(x, MC_BATCH, RUN_CFG["noise_level"], g)
    return batch


# torch.profiler traces taken of 19(a)'s replay and graphed chunk until one
# agrees with the launch counters
TRACE_TRIES = 3


def named(launches):
    """{wrapper: count} as {wrapper name: count}."""
    return {c.__name__: n for c, n in launches.items()}


def phase_graphs(torch, card, model, image):
    """Phase 19 on phase 4's model (the certify YAML's, full width): (a) one
    chunk with the step run eagerly and then replayed from its graph (a
    fresh capture): tokens equal, the last step's logits bit for bit (else
    within the attention limits, and said), decode seconds both ways, and
    the launches a replay adds to the counters those that a
    ``torch.profiler`` trace of one replay shows, as over a whole graphed
    chunk the trace's launches are the counters'; (b)
    the early exit at full width, an EOS bias on the lm_head (a ``bias``
    leaf, as the JAX ``bench.py`` adds one) chosen from the eager run's
    logits so that every row stops by token ``EXIT_BY_TOKEN``: fewer than 9
    steps launched, tokens the eager full loop's; (c) a second chunk
    captures nothing; (d) a replaced weight tensor is captured anew, its
    tokens the eager step's; (g) the peak memory beside phase 4's with the
    eager decode.
    (e) runs in phase 14.2 (the surrogates), (f) in phase 17.2 (the chat)."""
    from unittest import mock

    from certifiedgpt_tpu_torch.ops import cuda_kernels

    from certifiedgpt_tpu_torch.common.stages import StageClock
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    device, cfg = model.device, model.cfg
    eos, pad = model.tokenizer.eos_token_id, model.tokenizer.pad_token_id
    steps = RUN_CFG["max_new_tokens"]
    graphs = M._decode_graphs(model.params)
    batch = phase19_chunk(torch, model, image, seed=191)
    # (a): the step's logits recorded by a wrapper of the choice, in the eager
    # run and in a capture of its own (cleared after)
    seen, margins = {}, []
    pick = M._pick

    def recording_pick(logits, t, knobs, counts, generator):
        buf = seen.get("logits")
        if buf is None or buf.shape != logits.shape:
            buf = seen["logits"] = torch.empty_like(logits)
        buf.copy_(logits)
        if not torch.cuda.is_current_stream_capturing():
            margins.append(logits.max(dim=-1).values - logits[:, eos])
        return pick(logits, t, knobs, counts, generator)

    graphs.states.clear()
    runs = {}
    with mock.patch.object(M, "_pick", recording_pick):
        for mode in ("eager", "graph"):
            margins.clear()
            clock = StageClock(device)
            torch.cuda.synchronize()
            tokens = M.generate(model.params, cfg, batch, steps, eos, pad, clock=clock,
                                cuda_graph=mode == "graph")
            torch.cuda.synchronize()
            runs[mode] = (tokens.cpu(), seen["logits"].clone(), dict(clock.seconds),
                          [m.clone() for m in margins])
        # what a replay counts against what the card ran, from the profiler; a
        # trace at times lacks operations that ran (a profiler fault, not the
        # program's: the counters of the same run agree), so a trace that
        # disagrees is taken again, TRACE_TRIES in all, each try logged
        (st,) = [v for v in graphs.states.values() if v.graph is not None]
        every = cuda_kernels.LAUNCH_COUNTERS
        for attempt in range(1, TRACE_TRIES + 1):
            replay_traced, replay_ops = cuda_kernels.traced_launches(st.graph.replay)
            before = [c.launches for c in every]
            chunk_traced, chunk_ops = cuda_kernels.traced_launches(
                lambda: M.generate(model.params, cfg, batch, steps, eos, pad))
            chunk_counted = {c: c.launches - n for c, n in zip(every, before) if c.launches != n}
            agree = (replay_traced == st.launches and bool(st.launches)
                     and chunk_traced == chunk_counted)
            log(f"[graph] 19(a) try {attempt} of {TRACE_TRIES} ("
                f"{'agrees' if agree else 'DISAGREES'}): one replay in a torch.profiler trace: "
                f"{replay_ops} device operations, counted kernels {named(replay_traced)}, the "
                f"capture's record {named(st.launches)}; a graphed chunk: {chunk_ops} device "
                f"operations, counted kernels in the trace {named(chunk_traced)}, the counters "
                f"{named(chunk_counted)}")
            if agree:
                break
    graphs.states.clear()
    if not agree:
        fail(f"19(a): in none of {TRACE_TRIES} traces are the launches that a replay counts "
             "those the trace shows")
    record = {name: st.launches[fn] for name, fn in wrappers().items() if fn in st.launches}
    if record != PER_DECODE_STEP:
        fail(f"19(a): a replay records {record}, not PER_DECODE_STEP {PER_DECODE_STEP}")
    del st
    (tok_e, log_e, sec_e, marg), (tok_g, log_g, sec_g, _) = runs["eager"], runs["graph"]
    diff = bits_unequal(torch, log_g, log_e)
    rel = rel_err(log_g, log_e)
    log(f"[graph] 19(a) a certify chunk ({MC_BATCH} x {steps} tokens): tokens eager and from the "
        f"graph {'equal' if torch.equal(tok_e, tok_g) else 'DIFFERENT'}; the last step's logits "
        f"{diff} of {log_e.numel()} values not bit-identical (relative error {rel:.3e}); decode "
        f"{sec_e.get('decode', 0.0):.4f} s eager, {sec_g.get('decode', 0.0):.4f} s replayed "
        f"(its capture included: the first chunk), prefill {sec_e.get('prefill', 0.0):.4f} / "
        f"{sec_g.get('prefill', 0.0):.4f} s; {card}")
    if not torch.equal(tok_e, tok_g) or (diff and not rel < KV8_REL_LIMIT):
        fail("19(a): the graphed step disagrees with the eager step")

    # (c) a second chunk captures nothing; the first (after the clear) once
    captures = M.generate.captures
    clock_times = []
    for seed in (192, 193):
        b = phase19_chunk(torch, model, image, seed=seed)
        clock = StageClock(device)
        got = M.generate(model.params, cfg, b, steps, eos, pad, clock=clock)
        want = M.generate(model.params, cfg, b, steps, eos, pad, cuda_graph=False)
        if not torch.equal(got, want):
            fail(f"19(c): chunk {seed}'s graphed tokens differ from the eager step's")
        clock_times.append(clock.seconds.get("decode", 0.0))
    if M.generate.captures != captures + 1:
        fail(f"19(c): two chunks made {M.generate.captures - captures} captures, want 1")
    log(f"[graph] 19(c) two more chunks: 1 capture (the first), none for the second; decode "
        f"{clock_times[0]:.4f} s (with the capture), then {clock_times[1]:.4f} s replayed; "
        f"tokens equal to the eager step's; {card}")

    # (b) the early exit at full width: an EOS bias from the eager run's margins
    per_row = torch.stack(marg[:EXIT_BY_TOKEN], dim=1).min(dim=1).values
    bias_value = float(per_row.max()) * 1.001 + 1e-3
    params = model.params
    bias = torch.zeros((cfg.llama.vocab_size,), dtype=torch.float32, device=device)
    bias[eos] = bias_value
    params["llama"]["lm_head"]["bias"] = bias
    captures = M.generate.captures
    want = M.generate(params, cfg, batch, steps, eos, pad, cuda_graph=False)
    M.generate(params, cfg, batch, steps, eos, pad)  # the capture
    M.generate.decode_steps = 0
    got = M.generate(params, cfg, batch, steps, eos, pad, early_exit=True)
    launched = M.generate.decode_steps
    first_eos = [row.index(eos) if eos in row else steps for row in want.tolist()]
    if not torch.equal(got, want) or not launched < steps - 1 or max(first_eos) >= steps:
        fail(f"19(b): early exit at full width: {launched} steps launched, tokens "
             f"{'equal' if torch.equal(got, want) else 'different'}, EOS at {sorted(set(first_eos))}")
    log(f"[graph] 19(b) early exit at full width (EOS bias {bias_value:.4f} on the lm_head): "
        f"rows emit EOS at tokens {sorted(set(first_eos))}; {launched} decode steps launched of "
        f"{steps - 1}; tokens equal to the eager full loop's; {M.generate.captures - captures} "
        f"capture (the bias is a new tensor); {card}")

    # (d) a replaced weight tensor: captured anew
    params = model.params
    params["llama"]["norm"]["scale"] = params["llama"]["norm"]["scale"].clone()
    captures = M.generate.captures
    got = M.generate(params, cfg, batch, steps, eos, pad)
    want = M.generate(params, cfg, batch, steps, eos, pad, cuda_graph=False)
    if M.generate.captures != captures + 1 or not torch.equal(got, want) \
            or not torch.equal(got.cpu(), tok_e):
        fail("19(d): a replaced weight tensor was not captured anew, or its tokens differ")
    log(f"[graph] 19(d) the final norm's scale replaced by a copy: 1 new capture, tokens equal "
        f"to the eager step's and to 19(a)'s; the model keeps {len(graphs.states)} captures; "
        f"{card}")
    del params, bias
    graphs.states.clear()
    gc.collect()

    # (g) the peak over a graphed chunk, a fresh capture included
    torch.cuda.reset_peak_memory_stats()
    M.generate(model.params, cfg, batch, steps, eos, pad)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[graph] 19(g) peak memory over a graphed chunk with its capture {peak:.2f} GB; phase "
        f"4's certify (graphed) above; phase 4 with the eager decode {EAGER_DECODE_PEAK_GB:.2f} GB; "
        f"{card}")
    return {"decode_s_eager": sec_e.get("decode"), "decode_s_graph_with_capture":
            sec_g.get("decode"), "decode_s_replayed": clock_times[1],
            "logit_bits_unequal": diff, "exit_steps": launched, "peak_gb": peak}


# ----------------------------------------------------------------------
# phases 8, 9.3 and 10: the launcher on shipped configs
# ----------------------------------------------------------------------
LAUNCH_RUNS = (  # mode, shipped config (run unchanged), results file
    ("certify", "configs/certify_configs/vqav2_certify_noise_0.5.yaml", "certify"),
    ("smoothing_predict", "configs/certify_configs/vqav2_predict_noise_0.5.yaml", "predict"),
)
CONTINUOUS_CONFIG = "configs/certify_configs/vqav2_certify_continuous.yaml"
EVAL_CONFIG = "configs/eval_configs/vqav2_eval_noise_0.5.yaml"
# the dataset's size caps the configs' max_images
LAUNCH_IMAGES = 2
CONTINUOUS_IMAGES = 3  # fewer than the 8 slots: every chunk mixes images
EVAL_QUESTIONS = 10  # two batches of 8, the second padded from 2 rows
LAUNCH_ROW_KEYS = {
    "certify": {"index", "question_id", "label", "answer", "radius", "correct", "abstain",
                "seconds", "sigma", "n0", "n", "draws"},
    "predict": {"index", "question_id", "label", "answer", "correct", "abstain", "seconds",
                "sigma", "n", "draws"},
    "continuous": {"index", "question_id", "label", "answer", "radius", "correct", "abstain",
                   "elapsed_seconds", "sigma", "n0", "n", "draws"},
}
LAUNCH_SUMMARY_KEYS = {
    "certify": {"total", "sigma", "n0", "n", "alpha", "abstention_rate", "standard_accuracy",
                "certified_accuracy_at_radius", "mean_draws_per_image",
                "mean_seconds_per_image"},
    "predict": {"total", "sigma", "n", "alpha", "accuracy", "abstention_rate",
                "mean_seconds_per_image", "mean_draws_per_image"},
}
LAUNCH_SUMMARY_KEYS["continuous"] = LAUNCH_SUMMARY_KEYS["certify"] | {"continuous",
                                                                      "images_per_hour"}
EVAL_SUMMARY_KEYS = {"overall_accuracy", "per_answer_type", "per_question_type", "exact_match",
                     "token_f1", "answer_bias", "num_questions", "noise_level"}
# model-block paths of the shipped configs, pointed where nothing exists so
# that the model is built from its seed
CHECKPOINT_ENV = ("VICUNA_7B", "EVA_VIT_G", "QFORMER_CKPT", "MINIGPT4_STAGE2")


def write_vqa_set(root, n: int) -> None:
    """``n`` seeded 640x480 RGB JPEGs named as COCO val2014 images, and
    VQAv2-shaped question and annotation JSONs with 10 answers each."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(0)
    (root / "images").mkdir()
    questions, annotations = [], []
    for i in range(n):
        image_id = 9000 + i
        Image.fromarray(rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)).save(
            root / "images" / f"COCO_val2014_{image_id:012d}.jpg")
        questions.append({"question_id": i + 1, "image_id": image_id,
                          "question": "what animal is this?"})
        annotations.append({
            "question_id": i + 1, "image_id": image_id, "question_type": "what",
            "answer_type": "other",
            "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j + 1}
                        for j, a in enumerate(GT_ANSWERS)],
        })
    (root / "questions.json").write_text(json.dumps({"questions": questions}))
    (root / "annotations.json").write_text(json.dumps({"annotations": annotations}))


def write_finetuned(path, d_in: int, d_out: int):
    """A ``llama_proj`` checkpoint in the JAX package's ``.npz`` format
    (``model:`` + the parameter path, and an empty meta sidecar), seeded
    values unlike the synthetic init (whose bias is zero)."""
    import numpy as np

    rng = np.random.RandomState(7)
    arrays = {"model:llama_proj/kernel": (rng.randn(d_in, d_out) / math.sqrt(d_in))
              .astype(np.float32),
              "model:llama_proj/bias": (0.1 * rng.randn(d_out)).astype(np.float32)}
    np.savez(path, **arrays)
    with open(f"{path}.meta.json", "w") as handle:
        json.dump({}, handle)
    return arrays


def launch_files(root, n: int, d_in: int, d_out: int):
    """A written set of ``n`` images and a ``llama_proj`` checkpoint under
    ``root``; returns the environment the shipped YAMLs read (checkpoint
    paths of the model block where nothing exists) and the checkpoint."""
    write_vqa_set(root, n)
    ckpt = root / "vqav2_finetuned.npz"
    proj = write_finetuned(ckpt, d_in, d_out)
    env = {"VQAV2_IMAGES": str(root / "images"),
           "VQAV2_VAL_QUESTIONS": str(root / "questions.json"),
           "VQAV2_VAL_ANNOTATIONS": str(root / "annotations.json"),
           "VQA_FINETUNED": str(ckpt),
           **{name: str(root / "absent" / name.lower()) for name in CHECKPOINT_ENV}}
    return env, proj


def run_launch(torch, argv, env, out):
    """``launch.main(argv)`` with ``env`` (and ``OUTPUT_DIR=out``) set and
    ``encode_img`` spied on, the launch counters reset just before and read
    just after. Returns the summary, the CLI wall, the launches, the
    projection each ``encode_img`` call read (one call a chunk or a batch),
    the decode steps launched, the peak memory, the model build seconds
    (``certified.log``) and the card's state during the run."""
    import re
    from unittest import mock

    from certifiedgpt_tpu_torch import launch
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    encode_img = M.encode_img
    seen = []

    def spy(params, cfg, images, clock=None):
        seen.append(params["llama_proj"])
        return encode_img(params, cfg, images, clock)

    with mock.patch.dict(os.environ, dict(env, OUTPUT_DIR=str(out))), \
            mock.patch.object(M, "encode_img", spy), CardSampler() as card_state:
        reset_counts()
        M.generate.decode_steps = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = launch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    build = re.search(r"built model minigpt4 on \w+ in ([0-9.]+) s",
                      (out / "certified.log").read_text())
    if build is None:
        fail(f"{argv[0]}: certified.log has no model build line")
    return {"summary": summary, "wall": wall, "launches": launches, "seen": seen,
            "decode_steps": M.generate.decode_steps,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "build_s": float(build.group(1)), "card_state": card_state.summary()}


def check_projection(label, seen, proj, calls):
    """``encode_img`` ran ``calls`` times and read exactly the checkpoint's
    projection every time."""
    import torch

    if len(seen) != calls:
        fail(f"{label}: {len(seen)} encode_img calls for {calls} chunks or batches")
    ptrs = {(p["kernel"].data_ptr(), p["bias"].data_ptr()) for p in seen}
    if len(ptrs) != 1:
        fail(f"{label}: encode_img read {len(ptrs)} different projections")
    for key in ("kernel", "bias"):
        want = torch.from_numpy(proj[f"model:llama_proj/{key}"]).to(seen[0][key].device)
        if seen[0][key].dtype != torch.float32 or not torch.equal(seen[0][key], want):
            fail(f"{label}: the llama_proj {key} encode_img read is not the checkpoint's")


def read_rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def dispatched_chunks(row, n0: int, n: int, mc_batch: int, window: int) -> int:
    """Chunks of ``mc_batch`` draws a serial row's certification or
    prediction dispatched: certify's selection pass (``n0``) runs whole;
    the estimation pass (or predict's one pass) reads chunks until an early
    stop, which keeps up to ``window`` chunks dispatched past the last one
    read (abandoned in flight), never more than the pass has."""
    used = -(-(row["draws"] - n0) // mc_batch)
    return -(-n0 // mc_batch) + min(-(-n // mc_batch), used + window)


def check_certify_rows(label, rows, kind, count, budget, sigma):
    if len(rows) != count or any(set(r) != LAUNCH_ROW_KEYS[kind] for r in rows):
        fail(f"{label}: rows {rows} are not {count} rows with the JAX package's keys")
    for row in rows:
        if row["sigma"] != sigma or row["abstain"] != (row["label"] == -1) \
                or not 0 < row["draws"] <= budget \
                or not math.isfinite(row.get("radius", 0.0)) or row.get("radius", 0.0) < 0:
            fail(f"{label}: malformed row {row}")


# ----------------------------------------------------------------------
# phase 8: the launcher on the shipped certify and predict configs
# ----------------------------------------------------------------------
def phase_launcher(torch, card, d_in: int, d_out: int, main_summary):
    """``certifiedgpt_tpu_torch.launch.main`` on the shipped certify and
    predict YAMLs, unchanged (full width; the synthetic dataset of
    ``LAUNCH_IMAGES`` images caps ``max_images``; ``dispatch_window`` 4 by
    default), with ``vqa_finetuned`` pointing at a written projection
    checkpoint. Checks the rows and summaries against the JAX package's
    schema, that ``encode_img`` read exactly the checkpoint's projection,
    and that each path kernel launched its launches per chunk times the
    chunks dispatched. Returns each run's launches and rows."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    counted, rows_of = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_launch_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, LAUNCH_IMAGES, d_in, d_out)
        for mode, path, kind in LAUNCH_RUNS:
            out = root / f"out_{kind}"
            knobs = A.SmoothingKnobs.from_run(Config(path).run)
            res = run_launch(torch, [mode, "--config-path", path], env, out)
            summary = res["summary"]
            rows = read_rows(out / f"{kind}_results.jsonl")
            on_disk = json.loads((out / f"{kind}_summary.json").read_text())
            log(f"[launch] {mode} {path}: rows {json.dumps(rows)}")
            log(f"[launch] {mode}: summary {json.dumps(summary)}; launches "
                f"{json.dumps(res['launches'])}")
            n0 = knobs.n0 if kind == "certify" else 0
            n = knobs.n if kind == "certify" else knobs.predict_n
            check_certify_rows(mode, rows, kind, LAUNCH_IMAGES, n0 + n, knobs.sigma)
            if summary != on_disk or set(summary) != LAUNCH_SUMMARY_KEYS[kind] \
                    or summary["total"] != LAUNCH_IMAGES:
                fail(f"{mode}: summary {summary} does not have the JAX package's keys")
            chunks = sum(dispatched_chunks(r, n0, n, knobs.mc_batch, knobs.dispatch_window)
                         for r in rows)
            check_projection(mode, res["seen"], proj, chunks)
            check_counts(f"launch {mode}", res["launches"], PER_CHUNK["flash_cls"], chunks,
                         res["decode_steps"])
            row_s = sum(r["seconds"] for r in rows)
            line = (f"[launch] {mode}: dispatch_window {knobs.dispatch_window}; model build "
                    f"{res['build_s']:.3f} s; CLI wall {res['wall']:.3f} s, of which rows "
                    f"{row_s:.3f} s and other agent time {res['wall'] - res['build_s'] - row_s:.3f} s; "
                    f"{row_s / len(rows):.3f} s per "
                    f"{'certified' if kind == 'certify' else 'predicted'} image over {chunks} "
                    f"chunks dispatched ({row_s / chunks:.4f} s a chunk")
            if kind == "certify":
                per_chunk = main_summary["wall_seconds"] / main_summary["chunks"]
                line += f"; certify_item in phase 4, window 1 and a clock: {per_chunk:.4f} s a chunk"
            log(f"{line}); {res['decode_steps']} decode steps launched; peak memory "
                f"{res['peak_gb']:.2f} GB; {card}; card during the run: {res['card_state']}")
            counted[mode] = res["launches"]
            rows_of[kind] = rows
            gc.collect()
            torch.cuda.empty_cache()
            if kind == "certify":
                check_rows_with_chains(torch, mode, path, env, root, rows)
    return counted, rows_of


def check_rows_with_chains(torch, mode, path, env, root, rows):
    """The certify run again with the decoder's fused elementwise ops routed
    to the chains they replaced (phase 20) and the W8A8 product to the pair
    it replaced (phase 21), as the port computed before them: every row
    equal but for its seconds."""
    out = root / "out_certify_chains"
    with contextlib.ExitStack() as stack:
        for patch in chain_versions() + pair_versions(torch):
            stack.enter_context(patch)
        res = run_launch(torch, [mode, "--config-path", path], env, out)
    chains = read_rows(out / "certify_results.jsonl")

    def kept(r):
        return {k: v for k, v in r.items() if k != "seconds"}

    same = [kept(a) == kept(b) for a, b in zip(rows, chains)]
    log(f"[launch] {mode} with the chains the decoder's fused kernels replaced and the pair "
        f"the W8A8 GEMM replaced: rows "
        f"{json.dumps(chains)}; equal to the kernels' rows but for seconds: {same}; CLI wall "
        f"{res['wall']:.3f} s; launches {json.dumps(res['launches'])}")
    if len(chains) != len(rows) or not all(same):
        fail(f"{mode}: the rows with the replaced chains and pair differ from the kernels' "
             "rows")
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 9.3: the continuous scheduler on the shipped continuous config
# ----------------------------------------------------------------------
def phase_continuous(torch, card, d_in: int, d_out: int, serial_rows):
    """``launch.main`` on ``vqav2_certify_continuous.yaml`` unchanged
    (``active_images`` 8, ``dispatch_window`` 4) over ``CONTINUOUS_IMAGES``
    written images: every chunk mixes images. The rows have the JAX
    package's continuous keys, each certifies OTHER at the radius of phase
    8's serial rows after all its draws; the chunks dispatched are
    ceil(images x (n0 + n) / mc_batch), each with the path's launches.
    Returns the launches."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    knobs = A.SmoothingKnobs.from_run(Config(CONTINUOUS_CONFIG).run)
    if not knobs.continuous:
        fail(f"{CONTINUOUS_CONFIG} does not set run.continuous")
    budget = knobs.n0 + knobs.n
    chunks = -(-CONTINUOUS_IMAGES * budget // knobs.mc_batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_continuous_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, CONTINUOUS_IMAGES, d_in, d_out)
        out = root / "out_continuous"
        res = run_launch(torch, ["certify", "--config-path", CONTINUOUS_CONFIG], env, out)
        summary = res["summary"]
        rows = read_rows(out / "certify_results.jsonl")
        on_disk = json.loads((out / "certify_summary.json").read_text())
    log(f"[continuous] {CONTINUOUS_CONFIG}: rows {json.dumps(rows)}")
    log(f"[continuous] summary {json.dumps(summary)}; launches {json.dumps(res['launches'])}")
    check_certify_rows("continuous", rows, "continuous", CONTINUOUS_IMAGES, budget, knobs.sigma)
    if summary != on_disk or set(summary) != LAUNCH_SUMMARY_KEYS["continuous"] \
            or summary["continuous"] is not True or summary["total"] != CONTINUOUS_IMAGES:
        fail(f"continuous: summary {summary} does not have the JAX package's keys")
    radius = serial_rows["certify"][0]["radius"]
    for row in rows:
        if row["answer"] != "<other>" or row["radius"] != radius or row["draws"] != budget:
            fail(f"continuous: row {row} is not OTHER at radius {radius} after {budget} draws")
    check_projection("continuous", res["seen"], proj, chunks)
    check_counts("launch continuous", res["launches"], PER_CHUNK["flash_cls"], chunks,
                 res["decode_steps"])
    per_image = summary["mean_seconds_per_image"]
    serial = sum(r["seconds"] for r in serial_rows["certify"]) / len(serial_rows["certify"])
    log(f"[continuous] {chunks} chunks dispatched for {CONTINUOUS_IMAGES} images "
        f"(serial: {CONTINUOUS_IMAGES * (-(-knobs.n0 // knobs.mc_batch) - (-knobs.n // knobs.mc_batch))}); "
        f"{per_image:.3f} s per certified image (wall / images, the agent's), "
        f"{summary['images_per_hour']:.1f} images an hour, against {serial:.3f} s per image "
        f"serially in phase 8; {per_image * CONTINUOUS_IMAGES / chunks:.4f} s a chunk; "
        f"model build {res['build_s']:.3f} s, CLI wall {res['wall']:.3f} s; "
        f"{res['decode_steps']} decode steps launched; peak memory {res['peak_gb']:.2f} GB; "
        f"{card}; card during the run: {res['card_state']}")
    gc.collect()
    torch.cuda.empty_cache()
    return res["launches"]


# ----------------------------------------------------------------------
# phase 10: the eval agent on a shipped eval config
# ----------------------------------------------------------------------
def phase_eval(torch, card, d_in: int, d_out: int):
    """``launch.main`` in ``eval`` mode on ``vqav2_eval_noise_0.5.yaml``
    unchanged (batch 8, seq_len 320, early exit, ``dispatch_window`` 2 by
    default) over ``EVAL_QUESTIONS`` written questions: two batches, the
    second padded from 2 rows to 8. ``eval_results.json`` has the JAX
    package's summary keys and a prediction for every question; each batch
    ran the path's launches. Returns the launches."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.common.config import Config

    run = Config(EVAL_CONFIG).run
    batch = int(run.get("batch_size"))
    batches = -(-EVAL_QUESTIONS // batch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, EVAL_QUESTIONS, d_in, d_out)
        out = root / "out_eval"
        res = run_launch(torch, ["eval", "--config-path", EVAL_CONFIG], env, out)
        saved = json.loads((out / "eval_results.json").read_text())
    summary = res["summary"]
    log(f"[eval] {EVAL_CONFIG}: summary {json.dumps(summary)}; first predictions "
        f"{json.dumps(saved['predictions'][:3])}; launches {json.dumps(res['launches'])}")
    if saved["summary"] != summary or set(summary) != EVAL_SUMMARY_KEYS \
            or summary["num_questions"] != EVAL_QUESTIONS:
        fail(f"eval: summary {summary} does not have the JAX package's keys")
    if sorted(p["question_id"] for p in saved["predictions"]) != list(range(1, EVAL_QUESTIONS + 1)):
        fail(f"eval: predictions {saved['predictions']} do not cover the questions")
    check_projection("eval", res["seen"], proj, batches)
    check_counts("launch eval", res["launches"], PER_CHUNK["flash_cls"], batches,
                 res["decode_steps"])
    agent_s = res["wall"] - res["build_s"]
    log(f"[eval] {EVAL_QUESTIONS} questions in {batches} batches of {batch}: "
        f"{EVAL_QUESTIONS / agent_s:.3f} samples per second over the agent's run "
        f"({agent_s:.3f} s: dataset, JPEG decode, generate, scoring), "
        f"{EVAL_QUESTIONS / res['wall']:.3f} over the CLI wall ({res['wall']:.3f} s, model "
        f"build {res['build_s']:.3f} s); {res['decode_steps']} decode steps launched; peak "
        f"memory {res['peak_gb']:.2f} GB; {card}; card during the run: {res['card_state']}")
    gc.collect()
    torch.cuda.empty_cache()
    return res["launches"]


# ----------------------------------------------------------------------
# phase 11: training on the shipped VQAv2 finetuning configs
# ----------------------------------------------------------------------
TRAIN_W8A8_CONFIG = "configs/train_configs/vqav2_finetuning_noise_0.5_w8a8.yaml"
TRAIN_BF16_CONFIG = "configs/train_configs/vqav2_finetuning_noise_0.5.yaml"
# each run with max_epoch cut to this (its only change), inside the time limit
TRAIN_EPOCHS = 3
# a written VQAv2-shaped set: two train steps of 48 an epoch, one val batch
TRAIN_SAMPLES = 96
VAL_SAMPLES = 48
# 11.1 limits, kernels against their plain versions on one full-width batch
# of the _w8a8 config. The ViT's tokens agree within 5e-2 (phase 4's limit;
# 2.3e-2 measured), the projected image tokens within ~1.2e-2, and the loss
# averages over every answer token. The W8A8 decoder's backward amplifies
# a change of its image tokens ~25x: its int8 activation codes flip (one
# H100 at 700 W: the loss's gradient in the tokens 3.1e-1 apart, the
# projection's 8.9e-2; the controls below print a random change of the
# tokens of the same size, and the same decoder with weight-only int8
# products)
TRAIN_LOSS_REL_LIMIT = 1e-2
TRAIN_GRAD_REL_LIMIT = 0.25
# the projection's gradient with the decoder's activation quant off
# (weight-only int8 products): no codes to flip
WEIGHT_ONLY_GRAD_REL_LIMIT = 5e-2
# one decoder layer's straight-through backward against autograd through the
# same layer with the int8 kernels dequantized to bf16 and no activation
# quant: they differ only by the forward's int8 activation rounding (~1 %)
LAYER_GRAD_REL_LIMIT = 5e-2
# kernel launches a train step of 48 images: the ViT once and the decoder's
# forward and backward (autograd records the forward: the fused ops as
# autograd Functions); the bf16 towers run no int8 kernel
PER_TRAIN_STEP = {
    "w8a8": plus(VIT_PER_CHUNK["flash_cls"], VIT_INT8["flash_cls"], TRAIN_DECODER_INT8),
    "bf16": plus({"cls_split_attention": VIT_DEPTH}, TRAIN_DECODER),
}
# a val batch (no autograd): the decoder through its fused elementwise ops
PER_VAL_BATCH = {
    "w8a8": plus(VIT_PER_CHUNK["flash_cls"], VIT_INT8["flash_cls"], VAL_DECODER_INT8),
    "bf16": plus({"cls_split_attention": VIT_DEPTH}, DECODER_FUSED, TRAIN_ATTENTION),
}


def pipeline_step_launches(n_micro: int):
    """A pipelined W8A8 train step's launches: the ViT once, the decoder's
    forward and backward once a microbatch but the final norm's, once a
    step."""
    final = {"add_rms_norm": 1, "add_rms_norm_grad": 1}
    return plus(VIT_PER_CHUNK["flash_cls"], VIT_INT8["flash_cls"], final,
                times(plus(TRAIN_DECODER_INT8, times(final, -1)), n_micro))


def write_train_set(root) -> dict:
    """Seeded 640x480 JPEGs named as COCO train2014 (``TRAIN_SAMPLES``) and
    val2014 (``VAL_SAMPLES``) images with VQAv2-shaped question and
    annotation JSONs; returns the environment the train YAMLs read (the
    model block's checkpoint paths where nothing exists)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(3)
    (root / "train_images").mkdir()
    env = {"VQAV2_IMAGES": str(root / "train_images"),
           **{name: str(root / "absent" / name.lower()) for name in CHECKPOINT_ENV}}
    for split, n, base in (("train", TRAIN_SAMPLES, 20000), ("val", VAL_SAMPLES, 30000)):
        questions, annotations = [], []
        for i in range(n):
            image_id = base + i
            Image.fromarray(rng.randint(0, 255, (480, 640, 3), dtype=np.uint8)).save(
                root / "train_images" / f"COCO_{split}2014_{image_id:012d}.jpg")
            questions.append({"question_id": image_id, "image_id": image_id,
                              "question": "what animal is this?"})
            annotations.append({
                "question_id": image_id, "image_id": image_id, "question_type": "what",
                "answer_type": "other",
                "answers": [{"answer": a, "answer_confidence": "yes", "answer_id": j + 1}
                            for j, a in enumerate(GT_ANSWERS)]})
        for kind, rows in (("QUESTIONS", {"questions": questions}),
                           ("ANNOTATIONS", {"annotations": annotations})):
            path = root / f"{split}_{kind.lower()}.json"
            path.write_text(json.dumps(rows))
            env[f"VQAV2_{split.upper()}_{kind}"] = str(path)
    return env


def config_with_run(path: str, out, **run):
    """A copy of the shipped YAML ``path`` at ``out`` with only the run
    block's ``run`` keys set; its ``${env:...}`` values stay as written."""
    import yaml

    with open(path) as handle:
        cfg = yaml.safe_load(handle)
    cfg["run"].update(run)
    out.write_text(yaml.safe_dump(cfg))
    return out


def cut_config(path: str, root, epochs: int):
    """A copy of the shipped YAML ``path`` with only ``run.max_epoch`` set to
    ``epochs``."""
    return config_with_run(path, root / os.path.basename(path), max_epoch=epochs)


def plain_versions():
    """Patches that route the path's kernels to their plain versions."""
    from unittest import mock

    from certifiedgpt_tpu_torch.models import eva_vit as V
    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import elementwise as E
    from certifiedgpt_tpu_torch.ops import flash_attention as FA
    from certifiedgpt_tpu_torch.ops import quantization as Q

    return [mock.patch.object(V, "cls_split_attention_parts", FA._cls_split_attention_plain),
            mock.patch.object(Q, "ln_quant_rows", Q._ln_quant_rows_plain),
            mock.patch.object(Q, "gelu_quant_rows", Q._gelu_quant_rows_as_plain),
            mock.patch.object(Q, "quantize_rows", Q._quantize_rows_plain),
            mock.patch.object(Q, "w8a8_product", Q._w8a8_product_plain),
            mock.patch.object(Q, "w8a8_epilogue", Q._w8a8_epilogue_plain),
            mock.patch.object(Q, "int8_weight_forward", Q._int8_weight_forward_plain),
            mock.patch.object(A, "multi_head_attention_kv8", A._multi_head_attention_kv8_plain),
            mock.patch.object(A, "prefill_attention_kv8", A._prefill_attention_kv8_plain),
            mock.patch.object(A, "decode_attention_kv8", A._decode_attention_kv8_plain),
            mock.patch.object(E, "add_rms_norm", E._add_rms_norm_plain),
            mock.patch.object(E, "rotary", E._rotary_plain),
            mock.patch.object(E, "silu_mul", E._silu_mul_plain),
            mock.patch.object(E, "add_rms_norm_grad", E._add_rms_norm_grad_plain),
            mock.patch.object(E, "rotary_grad", E._rotary_grad_plain),
            mock.patch.object(E, "silu_mul_grad", E._silu_mul_grad_plain),
            mock.patch.object(Q, "_grad_input", Q._grad_input_plain),
            mock.patch.object(A, "training_attention", A._training_attention_plain)]


def pair_versions(torch):
    """Patches that route the W8A8 product to the pair it replaced (the port
    before phase 21): ``torch._int_mm`` (rows zero-padded to 24 where
    fewer), then ``w8a8_epilogue``. A yardstick: the port never calls
    ``torch._int_mm``."""
    from unittest import mock

    from certifiedgpt_tpu_torch.ops import quantization as Q

    def product(xq, xs, kernel_q, scale, bias=None, dtype=torch.bfloat16):
        return Q.w8a8_epilogue(int_mm(torch, xq, kernel_q), xs, scale, bias, dtype)

    return [mock.patch.object(Q, "w8a8_product", product)]


def chain_versions():
    """Patches that route the decoder's fused elementwise ops to the chains
    they replaced (the port before phase 20's kernels): the plain residual
    add, RMSNorm, rotary and SiLU x up, and ``quantize_rows`` (its kernel)
    where the chain quantized their rows."""
    from unittest import mock

    from certifiedgpt_tpu_torch.ops import elementwise as E
    from certifiedgpt_tpu_torch.ops import quantization as Q

    def add_rms_norm(x, y, scale, eps=1e-6, quantize=False):
        s, out = E._add_rms_norm_plain(x, y, scale, eps)
        return s, (Q.quantize_rows(out) if quantize else out)

    def silu_mul(gate, up, quantize=False):
        out = E._silu_mul_plain(gate, up)
        return Q.quantize_rows(out) if quantize else out

    return [mock.patch.object(E, "add_rms_norm", add_rms_norm),
            mock.patch.object(E, "rotary", E._rotary_plain),
            mock.patch.object(E, "silu_mul", silu_mul)]


TRACE_TOP_KERNELS = 10  # the largest kernels of a traced train step's part
# the forward's sources of elementwise/copy device time: each function's
# calls run under a profiler label of its name ((module, function, label));
# the backward's are autograd's nodes (``evaluate_function: <node>``)
FORWARD_SOURCES = (("llama", "_block", "decoder blocks"),
                   ("llama", "lm_head_logits", "lm_head"),
                   ("minigpt4", "cross_entropy_loss", "cross-entropy"))
SOURCE_LABEL = "train step source: "
NODE_LABEL = "autograd::engine::evaluate_function: "


def labelled(torch, label, fn):
    """``fn`` with each call under the profiler label ``label``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(SOURCE_LABEL + label):
            return fn(*args, **kwargs)

    return run


def source_of(event) -> str:
    """The innermost source of a traced host operation: a
    ``FORWARD_SOURCES`` label or an autograd node among its ancestors."""
    while event is not None:
        if event.name.startswith(SOURCE_LABEL):
            return event.name[len(SOURCE_LABEL):]
        if event.name.startswith(NODE_LABEL):
            return event.name[len(NODE_LABEL):]
        event = event.cpu_parent
    return "other"


def group_of(name: str) -> str:
    key = name.lower()
    return next((g for g, keys in PROFILE_GROUPS if any(k in key for k in keys)),
                "other elementwise / copy")


def train_step_groups(torch, model, cfg, batch) -> dict:
    """One train step of ``model`` on ``batch`` with the forward (ViT,
    Q-Former, projection, decoder, loss) and the backward each under a
    ``device_trace`` of its own (the host's operations traced too): for
    each part its wall seconds, device seconds, kernel launches, device
    seconds by ``PROFILE_GROUPS``, its ``TRACE_TOP_KERNELS`` largest kernels
    and its elementwise/copy device seconds by source (``source_of``). Uses
    only entry points that the port has had since its fused elementwise
    ops, so ``scripts/bench_torch_train_step.py`` runs it on an older
    checkout too."""
    from unittest import mock

    from certifiedgpt_tpu_torch.models import llama as LL
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    modules = {"llama": LL, "minigpt4": M}
    proj = model.module.llama_proj
    proj.kernel.grad = proj.bias.grad = None
    held = {}

    def forward():
        with torch.profiler.record_function(SOURCE_LABEL + "encode (ViT, Q-Former, projection)"):
            tokens = M.encode_img(model.params, cfg, batch["image"])
        with contextlib.ExitStack() as stack:
            for module, name, label in FORWARD_SOURCES:
                fn = getattr(modules[module], name)
                stack.enter_context(mock.patch.object(modules[module], name,
                                                      labelled(torch, label, fn)))
            held["loss"] = M.minigpt4_loss(model.params, cfg, batch, img_embeds=tokens)

    def backward():
        held.pop("loss").backward()

    parts = {}
    for part, fn in (("forward", forward), ("backward", backward)):
        with cuda_kernels.device_trace(cpu=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        groups, launches = {}, 0
        # the sources' labels show on the device's timeline too (as annotations
        # spanning their kernels): not operations of their own
        events = [e for e in cuda_kernels.device_events(prof.key_averages())
                  if e.self_device_time_total > 0 and not e.key.startswith(SOURCE_LABEL)]
        for e in events:
            group = group_of(e.key)
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e6
            launches += e.count
        sources = {}
        for e in prof.events():
            for k in getattr(e, "kernels", ()):
                if (group_of(k.name) == "other elementwise / copy"
                        and cuda_kernels._PAD_KERNEL not in k.name):
                    src = source_of(e)
                    sources[src] = sources.get(src, 0.0) + k.duration / 1e6
        events.sort(key=lambda e: -e.self_device_time_total)
        parts[part] = {"wall": wall, "device": sum(groups.values()), "launches": launches,
                       "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                       "top": [(e.key[:90], e.self_device_time_total / 1e6, e.count)
                               for e in events[:TRACE_TOP_KERNELS]],
                       "elementwise_by_source": dict(sorted(sources.items(),
                                                            key=lambda kv: -kv[1]))}
    proj.kernel.grad = proj.bias.grad = None
    return parts


def format_groups(parts: dict) -> str:
    """``train_step_groups``' parts as one line: each part's groups, its
    largest kernels (seconds, launches), then its elementwise/copy seconds
    by source."""
    return "; ".join(
        f"{part}: wall {p['wall']:.4f} s, device {p['device']:.4f} s, {p['launches']} launches "
        f"(" + ", ".join(f"{g} {s:.4f}" for g, s in p["groups"].items()) + "); largest: "
        + ", ".join(f"{name} {s:.4f} s x{n}" for name, s, n in p["top"])
        + "; elementwise/copy by source: "
        + ", ".join(f"{src} {s:.4f}" for src, s in p["elementwise_by_source"].items())
        for part, p in parts.items())


def phase_train_checks(torch, card, device, root, env):
    """11.1: on one full-width batch of the ``_w8a8`` config (48 written
    448 px images, pack 3, seq_len 256) the loss and the ``llama_proj``
    gradient through the kernels against the same through their plain
    versions; one decoder layer's straight-through backward against a
    dequantized bf16 reference; a batch whose last packed row is all
    padding gives a finite loss and finite gradients."""
    import dataclasses
    from unittest import mock

    from certifiedgpt_tpu_torch import registration  # noqa: F401 (the agents)
    from certifiedgpt_tpu_torch.agents.base import setup_agent
    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.models import layers as L
    from certifiedgpt_tpu_torch.models import llama as LL
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.ops import quantization as Q

    with mock.patch.dict(os.environ, dict(env, OUTPUT_DIR=str(root / "out_checks"))):
        agent = setup_agent(Config(TRAIN_W8A8_CONFIG), device=device)
        host = next(iter(agent.create_loaders()["train"]))
    batch = agent.device_batch(host)
    model, cfg = agent.model, agent.model.cfg
    proj = model.module.llama_proj

    def loss_and_grad(b, offset=None, run_cfg=cfg):
        """The loss, the projection's gradient, the image tokens (plus
        ``offset``) and the loss's gradient in them (what the decoder's
        backward hands the projection), and whether the bias gradient is
        finite."""
        proj.kernel.grad = proj.bias.grad = None
        tokens = M.encode_img(model.params, run_cfg, b["image"])
        if offset is not None:
            tokens = tokens + offset
        tokens.retain_grad()
        loss = M.minigpt4_loss(model.params, run_cfg, b, img_embeds=tokens)
        loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()), proj.kernel.grad.clone(), tokens.detach(),
                tokens.grad, bool(torch.isfinite(proj.bias.grad).all()))

    loss_and_grad(batch)  # warm-up
    reset_counts()
    dequantized_t = Q._dequantized_t
    made = []  # the straight-through backward's dequantized weights (none on the card)

    def counting(*args, **kwargs):
        made.append(1)
        return dequantized_t(*args, **kwargs)

    t0 = time.perf_counter()
    with mock.patch.object(Q, "_dequantized_t", counting):
        loss, grad, tokens, tokens_grad, _ = loss_and_grad(batch)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_counts("train 11.1", launches, PER_TRAIN_STEP["w8a8"], 1)
    if made:
        fail(f"train 11.1: the backward dequantized {len(made)} int8 kernels")
    weight_only = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, act_quant=False))
    wo_grad = loss_and_grad(batch, run_cfg=weight_only)[1]
    with contextlib.ExitStack() as stack:
        for patch in plain_versions():
            stack.enter_context(patch)
        plain_loss, plain_grad, plain_tokens, plain_tokens_grad, _ = loss_and_grad(batch)
        wo_plain_grad = loss_and_grad(batch, run_cfg=weight_only)[1]
    loss_rel = abs(loss - plain_loss) / abs(plain_loss)
    grad_rel = rel_err(grad, plain_grad)
    wo_rel = rel_err(wo_grad, wo_plain_grad)
    # control: the plain tokens changed at random by as much as the kernels
    # change them
    g = torch.Generator(device=device).manual_seed(7)
    noise = torch.randn(plain_tokens.shape, generator=g, device=device)
    noise *= (tokens.float() - plain_tokens.float()).norm() / noise.norm()
    with contextlib.ExitStack() as stack:
        for patch in plain_versions():
            stack.enter_context(patch)
        control = loss_and_grad(batch, offset=noise.to(plain_tokens.dtype))
    control_rel = rel_err(control[1], plain_grad)
    rows, seq = batch["input_ids"].shape
    log(f"[train] 11.1 {TRAIN_W8A8_CONFIG}: batch of {batch['image'].shape[0]} images as "
        f"{rows} packed rows x {seq}: loss {loss:.6f} through the kernels, {plain_loss:.6f} "
        f"through their plain versions (relative error {loss_rel:.3e}, limit "
        f"{TRAIN_LOSS_REL_LIMIT:g}); llama_proj gradient relative error (Frobenius) "
        f"{grad_rel:.3e} (limit {TRAIN_GRAD_REL_LIMIT:g}); on the way: projected image tokens "
        f"{rel_err(tokens, plain_tokens):.3e}, the loss's gradient in them (the decoder's "
        f"backward) {rel_err(tokens_grad, plain_tokens_grad):.3e}; forward + backward "
        f"{seconds:.3f} s; launches {json.dumps(launches)}; the backward's dequantized int8 "
        f"kernels (_dequantized_t) {len(made)}; {card}")
    log(f"[train] 11.1 controls: the plain path with its image tokens changed at random by as "
        f"much: the loss's gradient in them {rel_err(control[3], plain_tokens_grad):.3e}, the "
        f"projection's {control_rel:.3e}; the decoder with weight-only "
        f"int8 products (no activation quant), kernels against plain versions: the "
        f"projection's gradient {wo_rel:.3e} (limit {WEIGHT_ONLY_GRAD_REL_LIMIT:g})")
    if not (math.isfinite(loss) and bool(torch.isfinite(grad).all())):
        fail("train 11.1: the loss or the llama_proj gradient is not finite")
    if not (loss_rel < TRAIN_LOSS_REL_LIMIT and grad_rel < TRAIN_GRAD_REL_LIMIT
            and wo_rel < WEIGHT_ONLY_GRAD_REL_LIMIT):
        fail("train 11.1: the loss or gradient through the kernels disagrees with the plain "
             "versions")

    # one decoder layer: the W8A8 straight-through backward against autograd
    # through the same layer with dequantized bf16 kernels
    g = torch.Generator(device=device).manual_seed(11)
    lp = L.layer_slice(model.params["llama"]["layers"], 0)
    lcfg = cfg.llama
    x = torch.randn((rows, seq, lcfg.hidden_size), generator=g, device=device).bfloat16()
    r = torch.randn((rows, seq, lcfg.hidden_size), generator=g, device=device)
    cos, sin = L.rotary_tables(lcfg.head_dim, lcfg.max_position_embeddings, lcfg.rope_theta,
                               device=device)
    mask = LL.TrainingMask(batch["attention_mask"], batch["segment_ids"])

    def layer_grad(params, layer_cfg):
        xx = x.clone().requires_grad_(True)
        out, y = LL._block(xx, None, params, layer_cfg, cos, sin, batch["positions"], mask)
        ((out + y).float() * r).sum().backward()
        return xx.grad

    dequantized = {name: {"kernel": (leaf["kernel_q"].float() * leaf["scale"]).bfloat16()}
                   if "kernel_q" in leaf else leaf for name, leaf in lp.items()}
    layer_rel = rel_err(layer_grad(lp, lcfg),
                        layer_grad(dequantized, dataclasses.replace(lcfg, act_quant=False)))
    log(f"[train] 11.1 decoder layer 0, W8A8 straight-through backward against a dequantized "
        f"bf16 layer at [{rows}, {seq}, {lcfg.hidden_size}]: input-gradient relative error "
        f"{layer_rel:.3e} (limit {LAYER_GRAD_REL_LIMIT:g})")
    if not layer_rel < LAYER_GRAD_REL_LIMIT:
        fail("train 11.1: the straight-through backward disagrees with the bf16 reference")

    # the last packed row all padding: every query of it fully masked
    padded = {k: v.clone() for k, v in batch.items()}
    for key, fill in (("input_ids", model.tokenizer.pad_token_id), ("attention_mask", 0),
                      ("labels", -100), ("segment_ids", 0), ("positions", 0)):
        padded[key][-1] = fill
    pad_loss, pad_grad, _, _, bias_ok = loss_and_grad(padded)
    finite = math.isfinite(pad_loss) and bool(torch.isfinite(pad_grad).all()) and bias_ok
    log(f"[train] 11.1 last packed row all padding: loss {pad_loss:.6f}, gradient finite "
        f"{finite}")
    if not finite:
        fail("train 11.1: a row of padding gives a loss or gradient that is not finite")

    # where a train step's time goes: each stage ends in a synchronize
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    proj.kernel.grad = proj.bias.grad = None
    tokens = M.encode_img(model.params, cfg, batch["image"])
    mark()
    loss = M.minigpt4_loss(model.params, cfg, batch, img_embeds=tokens)
    mark()
    loss.backward()
    mark()
    agent.optimizer.step()
    mark()
    parts = [b - a for a, b in zip(marks, marks[1:])]
    log(f"[train] 11.1 a train step's stages, each synchronized: ViT + Q-Former + projection "
        f"{parts[0]:.4f} s, decoder forward + loss {parts[1]:.4f} s, backward {parts[2]:.4f} s, "
        f"AdamW {parts[3]:.4f} s; {card}")
    groups = train_step_groups(torch, model, cfg, batch)
    if not all(p["device"] > 0 for p in groups.values()):
        fail("train 11.1: the profiler saw no device time in the train step")
    log(f"[train] 11.1 a train step by kernel group (device seconds): {format_groups(groups)}; "
        f"{card}")
    del padded, plain_grad, pad_grad, tokens, plain_tokens, loss
    del tokens_grad, plain_tokens_grad, wo_grad, wo_plain_grad
    gc.collect()
    t0 = time.perf_counter()
    launched = phase_pipeline(torch, card, agent, batch, control_rel)
    launched["train 11.1"] = launches
    log(f"[pipe] phase 16 took {time.perf_counter() - t0:.1f} s")
    del agent, model, batch, grad, control
    gc.collect()
    torch.cuda.empty_cache()
    return launched


PIPE_MICRO = (1, 2, 4)
PIPE_TIMED_STEPS = 3  # 16.1 ran each form once: they are warm


def phase_pipeline(torch, card, agent, batch, control_rel):
    """Phase 16, on 11.1's agent (the ``_w8a8`` YAML at full width) and
    packed batch (48 images, 16 rows x 256 tokens), with a one-process mesh
    whose pipe axis is 1: 16.1 ``pipeline_minigpt4_loss`` at each of
    ``PIPE_MICRO`` microbatch counts, its loss and ``llama_proj`` gradient
    against ``minigpt4_loss`` through the kernels on the same parameters
    (11.1's limits; 11.1's random-change control printed beside), the
    three path kernels' launches a step (39 / 156 / 78, the others none),
    the schedule's backward run once a step and the sequential decoder
    never; 16.2 a
    synchronized forward + backward at each count beside the sequential
    one (the median of ``PIPE_TIMED_STEPS``, 16.1 having run each) and its peak
    device memory; 16.3 the sequential step and the last count's under
    ``torch.profiler``: summed kernel time, busy share, kernel launches.
    Returns the launches of each count's step."""
    from unittest import mock

    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.parallel import pipeline as PP
    from certifiedgpt_tpu_torch.parallel.mesh import make_mesh

    model, cfg = agent.model, agent.model.cfg
    proj = model.module.llama_proj
    mesh = make_mesh(n_pipe=1)
    rows, seq = batch["input_ids"].shape

    def step(n_micro):
        proj.kernel.grad = proj.bias.grad = None
        if n_micro is None:
            loss = M.minigpt4_loss(model.params, cfg, batch)
        else:
            loss = PP.pipeline_minigpt4_loss(model.params, cfg, batch, mesh, n_micro)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), proj.kernel.grad

    def no_sequential(*args, **kwargs):
        raise AssertionError("the pipelined loss called the sequential decoder")

    # 11.1's stage split stepped AdamW: the reference is taken anew
    seq_loss, seq_grad = step(None)
    seq_grad = seq_grad.clone()
    launched = {}
    for n_micro in PIPE_MICRO:
        backward = mock.patch.object(PP._Schedule, "backward", autospec=True,
                                     side_effect=PP._Schedule.backward)
        with backward as spy, mock.patch.object(M, "llama_apply", no_sequential):
            reset_counts()
            loss, grad = step(n_micro)
            launches = read_counts()
        check_counts(f"pipe 16.1 n_micro={n_micro}", launches, pipeline_step_launches(n_micro),
                     1)
        if spy.call_count != 1:
            fail(f"pipe 16.1 n_micro={n_micro}: the schedule's backward ran "
                 f"{spy.call_count} times in a step")
        loss_rel = abs(loss - seq_loss) / abs(seq_loss)
        grad_rel = rel_err(grad, seq_grad)
        log(f"[pipe] 16.1 n_micro={n_micro} ({rows // n_micro} rows x {seq} a microbatch, one "
            f"stage): loss {loss:.6f} against the sequential {seq_loss:.6f} (relative error "
            f"{loss_rel:.3e}, limit {TRAIN_LOSS_REL_LIMIT:g}); llama_proj gradient relative "
            f"error {grad_rel:.3e} (limit {TRAIN_GRAD_REL_LIMIT:g}; 11.1's control, a random "
            f"change of the image tokens: {control_rel:.3e}); launches {json.dumps(launches)}")
        if not (math.isfinite(loss) and bool(torch.isfinite(grad).all())):
            fail(f"pipe 16.1 n_micro={n_micro}: the loss or the gradient is not finite")
        if not (loss_rel < TRAIN_LOSS_REL_LIMIT and grad_rel < TRAIN_GRAD_REL_LIMIT):
            fail(f"pipe 16.1 n_micro={n_micro}: the pipelined loss or gradient disagrees "
                 "with the sequential decoder's")
        launched[f"train pipeline n_micro={n_micro}"] = launches

    timed = {}
    for n_micro in (None, *PIPE_MICRO):
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(PIPE_TIMED_STEPS):
            t0 = time.perf_counter()
            step(n_micro)
            times.append(time.perf_counter() - t0)
        name = "sequential" if n_micro is None else f"n_micro={n_micro}"
        timed[name] = sorted(times)[len(times) // 2]
        log(f"[pipe] 16.2 {name}: forward + backward {timed[name]:.4f} s a step (median of "
            f"{PIPE_TIMED_STEPS}, warmed by 16.1; min {min(times):.4f}, max {max(times):.4f}), "
            f"{timed[name] / timed['sequential']:.3f} x the sequential; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")

    # 16.3: where a step's extra time goes: device work, or idle gaps
    from certifiedgpt_tpu_torch.ops import cuda_kernels

    for n_micro in (None, PIPE_MICRO[-1]):
        with cuda_kernels.device_trace(cpu=True) as prof:
            t0 = time.perf_counter()
            step(n_micro)
            wall = time.perf_counter() - t0
        kernels = [e for e in cuda_kernels.device_events(prof.key_averages())
                   if e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        if busy <= 0:
            fail("pipe 16.3: the profiler saw no device time")
        name = "sequential" if n_micro is None else f"n_micro={n_micro}"
        log(f"[pipe] 16.3 {name} under torch.profiler: wall {wall:.4f} s, summed kernel time "
            f"{busy:.4f} s ({100 * busy / wall:.1f} % busy), "
            f"{sum(e.count for e in kernels)} kernel launches; {card}")
    proj.kernel.grad = proj.bias.grad = None
    return launched


def phase_train_runs(torch, card, root, env):
    """11.2: ``launch.main(["train", ...])`` on the shipped ``_w8a8`` and
    bf16 VQAv2 finetuning YAMLs (``max_epoch`` cut to ``TRAIN_EPOCHS``),
    each train step and val batch timed (synchronized) with the kernels'
    launches counted; checks the losses, the artifacts and the launches.
    Returns each run's launches and the W8A8 run's output directory and
    initial projection."""
    from unittest import mock

    import numpy as np

    from certifiedgpt_tpu_torch.agents import finetune as F
    from certifiedgpt_tpu_torch.common.config import Config

    counted, w8a8 = {}, None
    for kind, path in (("w8a8", TRAIN_W8A8_CONFIG), ("bf16", TRAIN_BF16_CONFIG)):
        run = Config(path).run
        name = str(run.get("checkpoint_name"))
        cut = cut_config(path, root, TRAIN_EPOCHS)
        out = root / f"out_train_{kind}"
        calls = {"train": [], "val": []}
        first_proj = []

        def timed(split, original):
            def call(self, batch, *args):
                if not first_proj:
                    first_proj.append(self.model.module.llama_proj.kernel.detach().clone())
                torch.cuda.synchronize()
                before = read_counts()
                t0 = time.perf_counter()
                result = original(self, batch, *args)
                torch.cuda.synchronize()
                after = read_counts()
                calls[split].append((time.perf_counter() - t0,
                                     {k: after[k] - before[k] for k in after},
                                     batch["image"].shape[0], batch["input_ids"].numel()))
                return result
            return call

        with mock.patch.object(F.FinetuneAgent, "_train_step",
                               timed("train", F.FinetuneAgent._train_step)), \
                mock.patch.object(F.FinetuneAgent, "_eval_step",
                                  timed("val", F.FinetuneAgent._eval_step)):
            res = run_launch(torch, ["train", "--config-path", str(cut)], env, out)
        summary = res["summary"]
        history = json.loads((out / "loss_history.json").read_text())
        steps = TRAIN_EPOCHS * (TRAIN_SAMPLES // int(run.get("batch_size")))
        log(f"[train] 11.2 {kind} {path} (max_epoch {TRAIN_EPOCHS}): summary "
            f"{json.dumps(summary)}; losses {json.dumps(history)}; launches "
            f"{json.dumps(res['launches'])}")
        if summary["steps"] != steps or summary["epochs"] != TRAIN_EPOCHS \
                or len(history["train"]) != TRAIN_EPOCHS or len(history["val"]) != TRAIN_EPOCHS \
                or not all(math.isfinite(v) for v in history["train"] + history["val"]):
            fail(f"train {kind}: {summary}, losses {history} are not {TRAIN_EPOCHS} finite "
                 f"epochs of {steps // TRAIN_EPOCHS} steps")
        files = {}
        for f in (f"{name}.npz", f"{name}.npz.meta.json", f"{name}_best.npz",
                  f"{name}_best.npz.meta.json", f"{name}.txt", "loss_history.json"):
            if not (out / f).exists():
                fail(f"train {kind}: {f} was not written")
            files[f] = (out / f).stat().st_size
        opt_keys = [k for k in np.load(out / f"{name}.npz").files if k.startswith("opt:")]
        if not opt_keys:
            fail(f"train {kind}: the resume checkpoint holds no optimizer state")
        for split, rows in calls.items():
            per_step = (PER_TRAIN_STEP if split == "train" else PER_VAL_BATCH)[kind]
            for _, launched, _, _ in rows:
                for kernel, n in launched.items():
                    if n != per_step.get(kernel, 0):
                        fail(f"train {kind} {split}: kernel {kernel} launched {n} times a "
                             f"step, expected {per_step.get(kernel, 0)}")
        if len(calls["train"]) != steps or len(calls["val"]) != TRAIN_EPOCHS:
            fail(f"train {kind}: {len(calls['train'])} train steps and {len(calls['val'])} "
                 f"val batches timed")
        times = sorted(t for t, _, _, _ in calls["train"][1:])
        median = times[len(times) // 2]
        _, _, samples, tokens = calls["train"][0]
        val = sorted(t for t, _, _, _ in calls["val"][1:])
        log(f"[train] 11.2 {kind}: {median:.4f} s a train step (median of {len(times)} after "
            f"the first, {calls['train'][0][0]:.4f} s; min {times[0]:.4f}, max "
            f"{times[-1]:.4f}), {samples / median:.2f} samples a second, {tokens / median:.1f} "
            f"decoder tokens a second ({samples} samples as {tokens} tokens a step); val batch "
            f"{val[len(val) // 2]:.4f} s (median after the first); peak memory "
            f"{res['peak_gb']:.2f} GB; model build {res['build_s']:.3f} s; CLI wall "
            f"{res['wall']:.3f} s; launches a train step and a val batch "
            f"{json.dumps(calls['train'][0][1])}; files {json.dumps(files)}; {card}; card during "
            f"the run: {res['card_state']}")
        counted[f"train {kind}"] = res["launches"]
        if kind == "w8a8":
            w8a8 = (out / f"{name}_best.npz", first_proj[0])
        gc.collect()
        torch.cuda.empty_cache()
    return counted, w8a8


def phase_train_predict(torch, card, root, best, initial, d_in, d_out):
    """11.3: the port's predict agent on phase 8's two images with
    ``model.vqa_finetuned`` the W8A8 run's ``_best`` checkpoint: every
    ``encode_img`` call reads that projection, which training moved away
    from the initial one."""
    import numpy as np

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    mode, path, kind = LAUNCH_RUNS[1]
    sub = root / "predict"
    sub.mkdir()
    env, _ = launch_files(sub, LAUNCH_IMAGES, d_in, d_out)
    env["VQA_FINETUNED"] = str(best)
    with np.load(best) as data:
        proj = {k: data[k] for k in data.files}
    if np.array_equal(proj["model:llama_proj/kernel"], initial.cpu().numpy()):
        fail("train 11.3: the trained projection equals the initial one")
    knobs = A.SmoothingKnobs.from_run(Config(path).run)
    out = sub / "out"
    res = run_launch(torch, [mode, "--config-path", path], env, out)
    rows = read_rows(out / f"{kind}_results.jsonl")
    check_certify_rows("train 11.3", rows, kind, LAUNCH_IMAGES, knobs.predict_n, knobs.sigma)
    chunks = sum(dispatched_chunks(r, 0, knobs.predict_n, knobs.mc_batch, knobs.dispatch_window)
                 for r in rows)
    check_projection("train 11.3", res["seen"], proj, chunks)
    log(f"[train] 11.3 {mode} {path} with vqa_finetuned {best.name}: every encode_img call "
        f"({chunks}) read the trained projection; rows {json.dumps(rows)}; {card}")
    return res["launches"]


def phase_train(torch, card, device, d_in: int, d_out: int):
    """Phase 11: 11.1, 11.2 and 11.3 on one written set. Returns the
    launches of each launcher run."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        env = write_train_set(root)
        pipe_launches = phase_train_checks(torch, card, device, root, env)
        counted, (best, initial) = phase_train_runs(torch, card, root, env)
        counted.update(pipe_launches)
        counted["predict trained"] = phase_train_predict(torch, card, root, best, initial,
                                                         d_in, d_out)
    return counted


# ----------------------------------------------------------------------
# phase 12: the shipped certify config from full-width checkpoint files
# ----------------------------------------------------------------------
CKPT_SEED = 12
# the four files take ~16 GB: Vicuna 6.74 G parameters in bf16, the ViT
# 0.99 G in f16, the Q-Former ~0.11 G in f32
CKPT_DISK_GB = 20
CKPT_IMAGES = 1
# the safetensors dtype names of the tensors written
ST_DTYPES = {"torch.float32": "F32", "torch.float16": "F16", "torch.bfloat16": "BF16"}
# the stacks' layers whose written tensors are kept to check the load
VICUNA_MODULES = {"q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
                  "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
                  "down_proj": "mlp"}
VIT_KERNELS = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
# the tokenizer trained in the phase: a BPE over a small corpus, its
# vocabulary padded to the decoder's 32000 ids
TOKENIZER_CORPUS = ["what animal is this? a cat sits on the mat", "the dog runs fast",
                    "yes no two three blue red <Img> </Img> [vqa] [INST] [/INST]",
                    "based on the image, answer the question"] * 8


def write_safetensors(torch, path, specs, make):
    """A ``.safetensors`` file of ``specs`` [(name, shape, dtype)]: the
    header, then each tensor ``make(name, shape, dtype)`` copied to the host
    and written, one at a time."""
    import struct

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, shape, dtype in specs:
        size = math.prod(shape) * dtype.itemsize
        header[name] = {"dtype": ST_DTYPES[str(dtype)], "shape": list(shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as handle:
        handle.write(struct.pack("<Q", len(blob)))
        handle.write(blob)
        for name, shape, dtype in specs:
            handle.write(make(name, shape, dtype).contiguous().cpu().reshape(-1)
                         .view(torch.uint8).numpy())
    return offset


class CheckpointWriter:
    """Seeded tensors drawn on the card for the four checkpoint files; the
    tensors the load checks read are kept on the host (``kept``)."""

    def __init__(self, torch, device, keep):
        self.torch, self.device, self.keep = torch, device, keep
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(CKPT_SEED)
        self.kept = {}

    def __call__(self, name, shape, dtype, std=0.02, offset=0.0):
        t = self.torch.randn(shape, generator=self.gen, device=self.device) * std + offset
        t = t.to(dtype)
        if self.keep(name):
            self.kept[name] = t.cpu()
        return t

    def linear(self, name, shape, dtype):
        """A Linear weight (std 1/sqrt(fan-in)), a norm's weight (1 +
        noise) or a bias, by name."""
        if name.endswith(("norm.weight", "LayerNorm.weight", "norm1.weight", "norm2.weight",
                          "layernorm.weight")):
            return self(name, shape, dtype, offset=1.0)
        if len(shape) == 2 and "embed" not in name and name != "lm_head.weight":
            return self(name, shape, dtype, std=shape[1] ** -0.5)
        return self(name, shape, dtype)


def vicuna_specs(torch, lc):
    """HF ``LlamaForCausalLM`` tensors in two shards: the embeddings and
    the first half of the layers, then the rest, the norm and the head."""
    d, inter, n = lc.hidden_size, lc.intermediate_size, lc.num_layers
    shapes = {"q_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d), "o_proj": (d, d),
              "gate_proj": (inter, d), "up_proj": (inter, d), "down_proj": (d, inter)}

    def layer(i):
        p = f"model.layers.{i}."
        out = [(f"{p}{VICUNA_MODULES[m]}.{m}.weight", s, torch.bfloat16)
               for m, s in shapes.items()]
        return out + [(p + "input_layernorm.weight", (d,), torch.bfloat16),
                      (p + "post_attention_layernorm.weight", (d,), torch.bfloat16)]

    first = [("model.embed_tokens.weight", (lc.vocab_size, d), torch.bfloat16)]
    first += [spec for i in range(n // 2) for spec in layer(i)]
    second = [spec for i in range(n // 2, n) for spec in layer(i)]
    second += [("model.norm.weight", (d,), torch.bfloat16),
               ("lm_head.weight", (lc.vocab_size, d), torch.bfloat16)]
    return first, second


def write_tokenizer(path, vocab: int) -> bool:
    """A BPE tokenizer trained on ``TOKENIZER_CORPUS`` (Metaspace, as
    LLaMA's; unk 0, bos 1, eos 2, pad "$$" 3), its vocabulary padded with
    filler pieces to ``vocab`` ids (pieces of the model, not added tokens,
    as a real 32000-piece vocabulary), written as ``tokenizer.json`` and
    ``tokenizer_config.json``. False when ``tokenizers`` or
    ``transformers`` does not import."""
    try:
        import transformers  # noqa: F401
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    except ImportError:
        return False
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    tok.train_from_iterator(TOKENIZER_CORPUS, trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<unk>", "<s>", "</s>", "$$"]))
    spec = json.loads(tok.to_str())
    pieces = spec["model"]["vocab"]
    for i in range(len(pieces), vocab):
        pieces[f"\u2581w{i}"] = i
    (path / "tokenizer.json").write_text(json.dumps(spec))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "pad_token": "$$", "model_max_length": 2048}))
    return True


def write_checkpoints(torch, device, root, cfg):
    """The four files at ``cfg``'s widths in the upstream formats: a Vicuna
    HF directory (``config.json``, two bf16 safetensors shards and their
    index, the tokenizer where it can be built), ``eva_vit_g.pth`` (f16,
    BEiT naming, the position table at the 224-px grid of 257 entries),
    the BLIP-2 ``.pth`` and the stage-2 ``.pth``. Returns the paths, the
    kept tensors, the seconds to write each and whether a tokenizer was
    written."""
    lc, vc, qc = cfg.llama, cfg.vit, cfg.qformer
    last_l, last_v, last_q = lc.num_layers - 1, vc.depth - 1, qc.num_layers - 1

    def keep(name):
        """The tensors outside the stacks, and the first and last layer's."""
        import re

        found = re.search(r"(model\.layers|blocks|encoder\.layer)\.(\d+)\.", name)
        if found is None:
            return True
        last = {"model.layers": last_l, "blocks": last_v, "encoder.layer": last_q}[found[1]]
        return int(found[2]) in (0, last)

    w = CheckpointWriter(torch, device, keep)
    paths = {"llama_model": root / "vicuna-7b", "eva_vit_g_pth": root / "eva_vit_g.pth",
             "q_former_model": root / "blip2_pretrained_flant5xxl.pth",
             "ckpt": root / "pretrained_minigpt4.pth"}
    seconds = {}

    t0 = time.perf_counter()
    vicuna = paths["llama_model"]
    vicuna.mkdir()
    (vicuna / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "hidden_size": lc.hidden_size, "intermediate_size": lc.intermediate_size,
        "num_hidden_layers": lc.num_layers, "num_attention_heads": lc.num_heads,
        "num_key_value_heads": lc.num_kv_heads, "vocab_size": lc.vocab_size,
        "max_position_embeddings": 2048, "rms_norm_eps": lc.rms_norm_eps,
        "bos_token_id": 1, "eos_token_id": 2, "pad_token_id": 0,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"}))
    weight_map, total = {}, 0
    shards = vicuna_specs(torch, lc)
    for k, specs in enumerate(shards):
        name = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(torch, vicuna / name, specs, w.linear)
        weight_map.update({spec[0]: name for spec in specs})
    (vicuna / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    tokenizer = write_tokenizer(vicuna, lc.vocab_size)
    seconds["llama_model"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    d, grid = vc.embed_dim, 224 // vc.patch_size
    h = torch.float16
    vit = {"patch_embed.proj.weight": w("patch_embed.proj.weight",
                                        (d, vc.in_channels, vc.patch_size, vc.patch_size), h,
                                        std=(vc.in_channels * vc.patch_size ** 2) ** -0.5),
           "patch_embed.proj.bias": w("patch_embed.proj.bias", (d,), h),
           "cls_token": w("cls_token", (1, 1, d), h),
           "pos_embed": w("pos_embed", (1, grid * grid + 1, d), h)}
    for i in range(vc.depth):
        b = f"blocks.{i}."
        for name, shape in (("norm1.weight", (d,)), ("norm1.bias", (d,)),
                            ("attn.qkv.weight", (3 * d, d)), ("attn.q_bias", (d,)),
                            ("attn.v_bias", (d,)), ("attn.proj.weight", (d, d)),
                            ("attn.proj.bias", (d,)), ("norm2.weight", (d,)), ("norm2.bias", (d,)),
                            ("mlp.fc1.weight", (vc.mlp_hidden, d)), ("mlp.fc1.bias", (vc.mlp_hidden,)),
                            ("mlp.fc2.weight", (d, vc.mlp_hidden)), ("mlp.fc2.bias", (d,))):
            vit[b + name] = w.linear(b + name, shape, h).cpu()
    torch.save(vit, paths["eva_vit_g_pth"])
    del vit
    seconds["eva_vit_g_pth"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    f32, qd = torch.float32, qc.hidden_size
    bert = {}

    def put(name, shape):
        bert["Qformer.bert." + name] = w.linear(name, shape, f32).cpu()

    def lin(name, d_out, d_in):
        put(name + ".weight", (d_out, d_in))
        put(name + ".bias", (d_out,))

    def ln(name):
        put(name + ".weight", (qd,))
        put(name + ".bias", (qd,))

    put("embeddings.word_embeddings.weight", (30523, qd))
    put("embeddings.position_embeddings.weight", (512, qd))
    ln("embeddings.LayerNorm")
    for i in range(qc.num_layers):
        b = f"encoder.layer.{i}."
        for part in ("query", "key", "value"):
            lin(f"{b}attention.self.{part}", qd, qd)
        lin(b + "attention.output.dense", qd, qd)
        ln(b + "attention.output.LayerNorm")
        if qc.has_cross_attention(i):
            lin(b + "crossattention.self.query", qd, qd)
            lin(b + "crossattention.self.key", qd, qc.encoder_width)
            lin(b + "crossattention.self.value", qd, qc.encoder_width)
            lin(b + "crossattention.output.dense", qd, qd)
            ln(b + "crossattention.output.LayerNorm")
        for branch in ("", "_query"):
            lin(f"{b}intermediate{branch}.dense", qc.intermediate_size, qd)
            lin(f"{b}output{branch}.dense", qd, qc.intermediate_size)
            ln(f"{b}output{branch}.LayerNorm")
    bert["query_tokens"] = w("query_tokens", (1, qc.num_query_tokens, qd), f32).cpu()
    # keys of the other BLIP-2 modules, which the loader's prefix drops
    bert["visual_encoder.cls_token"] = torch.zeros(1, 1, d)
    bert["t5_proj.weight"] = torch.zeros(8, qd)
    bert["t5_proj.bias"] = torch.zeros(8)
    torch.save({"model": bert}, paths["q_former_model"])
    del bert
    seconds["q_former_model"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    torch.save({"model": {
        "llama_proj.weight": w("llama_proj.weight", (lc.hidden_size, qd), f32, std=qd ** -0.5).cpu(),
        "llama_proj.bias": w("llama_proj.bias", (lc.hidden_size,), f32).cpu(),
        "ln_vision.weight": w("ln_vision.weight", (d,), f32, offset=1.0).cpu(),
        "ln_vision.bias": w("ln_vision.bias", (d,), f32).cpu()}}, paths["ckpt"])
    seconds["ckpt"] = time.perf_counter() - t0
    return {k: str(v) for k, v in paths.items()}, w.kept, seconds, tokenizer


def check_loaded_leaves(torch, params, kept, cfg) -> int:
    """The first and last layer of every stack, the position table, the
    embeddings and heads, ``llama_proj`` and ``ln_vision`` of the loaded
    model equal the written tensors transposed and cast to the model's
    dtypes (int8 stacks: ``quantize_kernel`` of them), bit for bit. Returns
    the number of leaves checked."""
    from certifiedgpt_tpu_torch.models.convert import interpolate_pos_embed
    from certifiedgpt_tpu_torch.ops.quantization import quantize_kernel

    device = params["llama_proj"]["kernel"].device
    checked = []

    def cast(name, dtype, transpose=False):
        t = kept[name].to(device).float()
        return (t.T if transpose else t).to(dtype)

    def same(label, got, want):
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            fail(f"phase 12: the loaded {label} ({got.dtype}, {tuple(got.shape)}) is not the "
                 f"written tensor transposed and cast ({want.dtype}, {tuple(want.shape)})")
        checked.append(label)

    def stack(label, tree, i, name, dtype):
        """Layer ``i`` of a stacked dense leaf: its kernel (or int8 codes
        and scales) and its bias where it has one."""
        want = cast(name + ".weight", dtype, transpose=True)
        if "kernel_q" in tree:
            q = quantize_kernel(want)
            same(label + " codes", tree["kernel_q"][i], q["kernel_q"])
            same(label + " scales", tree["scale"][i], q["scale"])
        else:
            same(label, tree["kernel"][i], want)
        if "bias" in tree:
            same(label + " bias", tree["bias"][i], cast(name + ".bias", dtype))

    lc, vc, qc = cfg.llama, cfg.vit, cfg.qformer
    llama, bf = params["llama"], lc.dtype
    for i in (0, lc.num_layers - 1):
        for mod, scope in VICUNA_MODULES.items():
            stack(f"decoder layer {i} {mod}", llama["layers"][mod], i,
                  f"model.layers.{i}.{scope}.{mod}", bf)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            same(f"decoder layer {i} {norm}", llama["layers"][norm]["scale"][i],
                 cast(f"model.layers.{i}.{norm}.weight", bf))
    same("embed_tokens", llama["embed_tokens"]["embedding"], cast("model.embed_tokens.weight", bf))
    same("lm_head", llama["lm_head"]["kernel"], cast("lm_head.weight", bf, transpose=True))
    same("decoder norm", llama["norm"]["scale"], cast("model.norm.weight", bf))

    vit, vt = params["vit"], vc.dtype
    for i in (0, vc.depth - 1):
        for mod, src in VIT_KERNELS.items():
            stack(f"ViT layer {i} {mod}", vit["layers"][mod], i, f"blocks.{i}.{src}", vt)
        for norm in ("norm1", "norm2"):
            same(f"ViT layer {i} {norm}", vit["layers"][norm]["scale"][i],
                 cast(f"blocks.{i}.{norm}.weight", vt))
            same(f"ViT layer {i} {norm} bias", vit["layers"][norm]["bias"][i],
                 cast(f"blocks.{i}.{norm}.bias", vt))
        for bias in ("q_bias", "v_bias"):
            same(f"ViT layer {i} {bias}", vit["layers"][bias][i], cast(f"blocks.{i}.attn.{bias}", vt))
    pos = interpolate_pos_embed(kept["pos_embed"], vc.num_patches)
    same("ViT pos_embed (the 224-px table resampled)", vit["pos_embed"], pos.to(device).to(vt))
    same("ViT cls_token", vit["cls_token"], cast("cls_token", vt))
    conv = kept["patch_embed.proj.weight"].to(device).float()
    same("ViT patch_embed", vit["patch_embed"]["kernel"],
         conv.reshape(conv.shape[0], -1).T.to(vt).contiguous())

    q, qt = params["qformer"], qc.dtype
    same("Q-Former query_tokens", q["query_tokens"], cast("query_tokens", qt))
    same("Q-Former word_embeddings", q["word_embeddings"]["embedding"],
         cast("embeddings.word_embeddings.weight", qt))
    for i in (0, qc.num_layers - 1):
        lp, b = q["layers"][f"layer_{i}"], f"encoder.layer.{i}."
        for leaf, name in (("self_q", "attention.self.query"), ("int_q", "intermediate_query.dense"),
                           ("int_txt", "intermediate.dense"), ("out_txt", "output.dense")):
            same(f"Q-Former layer {i} {leaf}", lp[leaf]["kernel"],
                 cast(f"{b}{name}.weight", qt, transpose=True))
            same(f"Q-Former layer {i} {leaf} bias", lp[leaf]["bias"], cast(f"{b}{name}.bias", qt))
    same("llama_proj kernel", params["llama_proj"]["kernel"],
         cast("llama_proj.weight", torch.float32, transpose=True))
    same("llama_proj bias", params["llama_proj"]["bias"], cast("llama_proj.bias", torch.float32))
    for leaf, name in (("scale", "weight"), ("bias", "bias")):
        same(f"ln_vision {leaf}", params["ln_vision"][leaf],
             cast(f"ln_vision.{name}", params["ln_vision"][leaf].dtype))
    return len(checked)


def phase_checkpoints(torch, card, device, main_summary):
    """Phase 12: write the four checkpoint files at full width (12.1), then
    run ``launch.main`` on the shipped certify YAML, unchanged, over one
    written image with the YAML's checkpoint variables pointing at them
    (12.2): the seconds to load each file, the model build, the peak host
    and device memory of the load, the row and its launches; the loaded
    leaves against the written tensors, and every ``encode_img`` reading
    the stage-2 projection. Returns the run's launches."""
    import resource
    import shutil
    import tempfile
    from pathlib import Path
    from unittest import mock

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.models import model_zoo as Z

    path = LAUNCH_RUNS[0][1]
    knobs = A.SmoothingKnobs.from_run(Config(path).run)
    cfg = Z.config_from_block(CERTIFY_MODEL_BLOCK)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        log(f"[ckpt] 12.1: {free_gb:.1f} GB free on the disk of {tmp}")
        if free_gb < CKPT_DISK_GB:
            fail(f"phase 12: {free_gb:.1f} GB free under {tmp}, the checkpoints need "
                 f"{CKPT_DISK_GB} GB")
        root = Path(tmp)
        t0 = time.perf_counter()
        paths, kept, write_s, tokenizer = write_checkpoints(torch, device, root, cfg)
        sizes = {k: sum(f.stat().st_size for f in Path(p).rglob("*")) if Path(p).is_dir()
                 else Path(p).stat().st_size for k, p in paths.items()}
        log(f"[ckpt] 12.1: wrote {json.dumps({k: round(v / 1e9, 3) for k, v in sizes.items()})} "
            f"GB in {json.dumps({k: round(v, 3) for k, v in write_s.items()})} s "
            f"({time.perf_counter() - t0:.3f} s with the tokenizer: "
            f"{'trained' if tokenizer else 'none, transformers or tokenizers does not import'})")

        (root / "vqa").mkdir()
        write_vqa_set(root / "vqa", CKPT_IMAGES)
        env = {"VQAV2_IMAGES": str(root / "vqa" / "images"),
               "VQAV2_VAL_QUESTIONS": str(root / "vqa" / "questions.json"),
               "VQAV2_VAL_ANNOTATIONS": str(root / "vqa" / "annotations.json"),
               "VQA_FINETUNED": "",  # the projection is the stage-2 file's
               **dict(zip(CHECKPOINT_ENV, (paths["llama_model"], paths["eva_vit_g_pth"],
                                           paths["q_former_model"], paths["ckpt"]))),
               }
        if not tokenizer:
            env["VICUNA_7B"] = str(root / "absent")
            log("[ckpt] 12.2: transformers does not import here, so the Vicuna directory "
                "(which needs its tokenizer) is left out of the YAML's run and loaded through "
                "load_llama_dir for the leaf checks")

        load, models = {}, []

        def timed(fn, key):
            def wrapper(*args, **kwargs):
                torch.cuda.synchronize()
                start = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                k = key(args) if callable(key) else key
                load[k] = load.get(k, 0.0) + time.perf_counter() - start
                return out
            return wrapper

        file_of = {p: k for k, p in paths.items()}
        from_config = Z.MiniGPT4Model.from_config.__func__

        def build(klass, block, device="cuda"):
            rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
            torch.cuda.reset_peak_memory_stats()
            model = from_config(klass, block, device)
            torch.cuda.synchronize()
            load["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
            load["model_gb"] = torch.cuda.memory_allocated() / 1e9
            load["host_rss_gb"] = (rss0, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)
            models.append(model)
            return model

        patches = [
            mock.patch.object(Z.MiniGPT4Model, "from_config", classmethod(build)),
            mock.patch.object(Z, "_torch_load", timed(Z._torch_load,
                                                      lambda a: f"{file_of.get(str(a[0]), a[0])} read")),
            mock.patch.object(Z, "load_llama_dir", timed(Z.load_llama_dir, "llama_model")),
            mock.patch.object(Z, "HFTokenizer", timed(Z.HFTokenizer, "tokenizer")),
            mock.patch.object(Z, "convert_eva_vit_state_dict",
                              timed(Z.convert_eva_vit_state_dict, "eva_vit_g_pth convert")),
            mock.patch.object(Z, "convert_qformer_state_dict",
                              timed(Z.convert_qformer_state_dict, "q_former_model convert")),
            mock.patch.object(Z, "load_projection", timed(Z.load_projection, "ckpt convert")),
        ]
        out = root / "out_certify"
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            res = run_launch(torch, ["certify", "--config-path", path], env, out)
        rows = read_rows(out / "certify_results.jsonl")
        log(f"[ckpt] 12.2 certify {path} from the files: rows {json.dumps(rows)}")
        check_certify_rows("phase 12", rows, "certify", CKPT_IMAGES, knobs.n0 + knobs.n,
                           knobs.sigma)
        if rows[0]["abstain"]:
            fail(f"phase 12: the row abstains: {rows[0]}")
        chunks = dispatched_chunks(rows[0], knobs.n0, knobs.n, knobs.mc_batch,
                                   knobs.dispatch_window)
        proj = {"model:llama_proj/kernel": kept["llama_proj.weight"].T.contiguous().numpy(),
                "model:llama_proj/bias": kept["llama_proj.bias"].numpy()}
        check_projection("phase 12", res["seen"], proj, chunks)
        check_counts("phase 12 certify", res["launches"], PER_CHUNK["flash_cls"], chunks,
                     res["decode_steps"])

        model = models[0]
        params = dict(model.params)
        if not tokenizer:
            params["llama"] = Z.load_llama_dir(paths["llama_model"], cfg.llama, device,
                                               bool(CERTIFY_MODEL_BLOCK["quantize_llama"]))
        checked = check_loaded_leaves(torch, params, kept, cfg)
        del model, models, params
        per_file = {k: round(load.get(f"{k} read", 0.0) + load.get(f"{k} convert", 0.0)
                             + load.get(k, 0.0), 3) for k in paths}
        rss0, rss1 = load["host_rss_gb"]
        log(f"[ckpt] 12.2: seconds to load each file (read + convert + quantize on the card) "
            f"{json.dumps(per_file)}, the tokenizer {load.get('tokenizer', 0.0):.3f} s; model "
            f"build {res['build_s']:.3f} s (certified.log); peak device memory of the load "
            f"{load['peak_device_gb']:.2f} GB for a {load['model_gb']:.2f} GB model; the "
            f"process's peak host RSS {rss0:.2f} GB before the load, {rss1:.2f} GB after; "
            f"{checked} loaded leaves equal the written tensors transposed and cast (int8: "
            f"quantize_kernel of them); every encode_img ({len(res['seen'])}) read the stage-2 "
            f"llama_proj; {card}")
        phase4 = ("phase 4 not run" if main_summary is None else
                  f"phase 4's certify_item on synthetic weights: "
                  f"{main_summary['wall_seconds'] / main_summary['chunks']:.4f} s a chunk")
        log(f"[ckpt] 12.2: {rows[0]['seconds']:.3f} s per certified image from the files over "
            f"{chunks} chunks ({rows[0]['seconds'] / chunks:.4f} s a chunk; {phase4}); "
            f"launches a chunk "
            f"{json.dumps({k: v // chunks for k, v in res['launches'].items()})}; "
            f"{res['decode_steps']} decode steps launched; peak memory {res['peak_gb']:.2f} GB; "
            f"CLI wall {res['wall']:.3f} s; card during the run: {res['card_state']}")
        return res["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 13: the decode modes on the card
# ----------------------------------------------------------------------
# run-block changes of the shipped eval config, one run each
DECODE_RUNS = (("beam search", {"num_beams": 3}),
               ("sampling", {"do_sample": True, "top_p": 0.9, "temperature": 1.0}),
               ("penalty", {"repetition_penalty": 1.2, "min_length": 2}))
DECODE_MIN_LENGTH = 3  # the chain model's rows end at steps 1-5 without it


def check_decode_modes(torch, device, card):
    """Phase 13's direct checks: on the full-width synthetic model of the
    eval config, ``generate_beam`` at one beam gives ``generate``'s greedy
    tokens, and sampling repeats with its seed and differs across seeds; on
    phase 9.2's chain model, no row emits EOS before ``min_length`` (and
    without it a row does at once), and ``generate`` with every knob on and
    the early exit is dispatched without a host sync."""
    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model

    run = Config(EVAL_CONFIG).run
    seq_len, steps = int(run.get("seq_len")), int(run.get("max_new_tokens"))
    model = MiniGPT4Model.from_config(CERTIFY_MODEL_BLOCK, device)
    prompt = build_gen_batch(model.tokenizer, [QUESTION] * EVAL_BATCH,
                             BatchSpec(seq_len=seq_len, num_img_tokens=model.cfg.num_img_tokens))
    g = torch.Generator(device=device)
    g.manual_seed(13)
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in prompt.items()}
    batch["image"] = torch.randn((EVAL_BATCH, *IMAGE_HWC), generator=g, device=device)
    tok = model.tokenizer
    args = (model.params, model.cfg, batch, steps, tok.eos_token_id, tok.pad_token_id)
    greedy = M.generate(*args)
    beam = M.generate_beam(*args, num_beams=1)
    if not torch.equal(beam, greedy):
        fail(f"phase 13: generate_beam at one beam {beam.tolist()} is not greedy {greedy.tolist()}")

    def sample(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return M.generate(*args, do_sample=True, top_p=0.9, temperature=1.0, generator=gen)

    first, again, other = sample(1), sample(1), sample(2)
    if not torch.equal(first, again) or torch.equal(first, other):
        fail("phase 13: sampling does not repeat with its seed, or two seeds drew the same tokens")
    del model, batch, args
    gc.collect()
    torch.cuda.empty_cache()

    chain, batch = chain_model(torch, device)
    eos, pad = 2, 0
    plain = M.generate(chain.params, chain.cfg, batch, EXIT_STEPS, eos, pad).cpu().tolist()
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    knobs = dict(do_sample=True, top_p=0.9, temperature=1.0, repetition_penalty=1.2,
                 min_length=DECODE_MIN_LENGTH, generator=gen, early_exit=True)
    # the capture of the knobs' step (it synchronizes once), on another generator
    M.generate(chain.params, chain.cfg, batch, EXIT_STEPS, eos, pad,
               **dict(knobs, generator=torch.Generator(device=device)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = M.generate(chain.params, chain.cfg, batch, EXIT_STEPS, eos, pad, **knobs)
    except RuntimeError as exc:
        fail(f"phase 13: generate with the decode knobs made the host wait for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = out.cpu().tolist()
    first_eos = [row.index(eos) if eos in row else EXIT_STEPS for row in out]
    if min(first_eos) < DECODE_MIN_LENGTH - 1 or plain[0][0] != eos:
        fail(f"phase 13: EOS before min_length {DECODE_MIN_LENGTH}: {out} (without it: {plain})")
    log(f"[decode] generate_beam at one beam equals greedy on the full-width model "
        f"({EVAL_BATCH} rows x {steps} tokens); sampling (top_p 0.9) repeats with its seed and "
        f"differs across seeds; on the chain model min_length {DECODE_MIN_LENGTH} holds EOS "
        f"back (first EOS at {first_eos}; without it {[r.index(eos) for r in plain]}); "
        f"generate with sampling, the repetition penalty, min_length and the early exit "
        f"dispatched with no sync (set_sync_debug_mode 'error'); {card}")


def phase_decode(torch, card, device, d_in: int, d_out: int):
    """Phase 13: ``launch.main`` in ``eval`` mode on
    ``vqav2_eval_noise_0.5.yaml`` with only its run block changed
    (``DECODE_RUNS``) over phase 10's ten written questions (synthetic
    weights, as phase 10): the JAX package's summary keys, a prediction
    for every question, each batch the path's launches and the stage-2
    or finetuned projection read; then ``check_decode_modes``. Returns the
    launches of each run."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.common.config import Config

    run = Config(EVAL_CONFIG).run
    batches = -(-EVAL_QUESTIONS // int(run.get("batch_size")))
    counted = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_decode_") as tmp:
        root = Path(tmp)
        env, proj = launch_files(root, EVAL_QUESTIONS, d_in, d_out)
        for name, knobs in DECODE_RUNS:
            tag = name.replace(" ", "_")
            cfg = config_with_run(EVAL_CONFIG, root / f"eval_{tag}.yaml", **knobs)
            out = root / f"out_{tag}"
            res = run_launch(torch, ["eval", "--config-path", str(cfg)], env, out)
            saved = json.loads((out / "eval_results.json").read_text())
            summary = res["summary"]
            if saved["summary"] != summary or set(summary) != EVAL_SUMMARY_KEYS \
                    or summary["num_questions"] != EVAL_QUESTIONS \
                    or sorted(p["question_id"] for p in saved["predictions"]) \
                    != list(range(1, EVAL_QUESTIONS + 1)):
                fail(f"phase 13 {name}: results {saved} do not have the JAX package's keys")
            check_projection(f"phase 13 {name}", res["seen"], proj, batches)
            check_counts(f"phase 13 {name}", res["launches"], PER_CHUNK["flash_cls"], batches,
                         res["decode_steps"])
            log(f"[decode] eval {EVAL_CONFIG} with {json.dumps(knobs)}: "
                f"{res['wall'] - res['build_s']:.3f} s over the agent's run ({EVAL_QUESTIONS} "
                f"questions in {batches} batches), CLI wall {res['wall']:.3f} s; "
                f"{res['decode_steps']} generate decode steps launched; peak memory "
                f"{res['peak_gb']:.2f} GB; launches {json.dumps(res['launches'])}; first "
                f"predictions {json.dumps(saved['predictions'][:2])}; {card}")
            counted[f"eval {name}"] = res["launches"]
            gc.collect()
            torch.cuda.empty_cache()
    check_decode_modes(torch, device, card)
    return counted


# ----------------------------------------------------------------------
# phase 14: the attack stage on the shipped attack config
# ----------------------------------------------------------------------
ATTACK_CONFIG = "configs/attack_configs/vqav2_attack.yaml"
ATTACK_IMAGES = 2  # the written set caps the YAML's max_images
# the YAML's backbones (and its run.attack_backbones order)
ATTACK_BACKBONES = ("rn50", "rn101", "vit_b16", "vit_b32", "vit_l14")
ATTACK_SEED = 14
ATTACK_TIMED_STEPS = 10  # PGD steps timed per backbone in 14.2
# 14.2, each surrogate on the card against the CPU (f32 both): relative
# (Frobenius) error of one image's embedding, share of the loss gradient's
# signs that agree
SURROGATE_EMBED_REL_LIMIT = 1e-4
SURROGATE_SIGN_SHARE = 0.99
# 14.3: the caption's first-step logits through the kernels may move from the
# plain versions' at most this many times as far as a random change of the
# plain image tokens by as much as the kernels changed them
CAPTION_LOGIT_FACTOR = 2.0
ATTACK_ROW_KEYS = {"index", "question_id", "backbone", "sigma", "target_text", "clean_caption",
                   "adv_caption", "clean_similarity", "adv_similarity", "similarity",
                   "success", "linf"}
ATTACK_SUMMARY_KEYS = {"total", "sigma_grid", "epsilon", "steps", "success_rate_per_backbone",
                       "overall_success_rate", "success_rate_grid", "ancova"}
CLIP_VIT_B32 = {"hidden": 768, "layers": 12, "inter": 3072, "patch": 32, "positions": 50,
                "proj": 512, "text_hidden": 512, "text_layers": 12, "text_inter": 2048,
                "vocab": 49408, "text_positions": 77}


def phase_attack_kernels(torch, device):
    """14.1: the three kernels of a victim caption at batch 1 against their
    plain versions, within phase 3's limits: the cls-split kernel with 16
    (b, h) pairs, the row-quant kernels at the patch stream's 1024 rows and
    the cls stream's one."""
    from certifiedgpt_tpu_torch.ops import quantization as Q

    ln_args, gelu_args = row_quant_args(torch, device, ATTACK_SEED)
    rows = (VIT_TOKENS, 1)  # one image's patch stream, its cls stream
    return {
        "cls_split_attention": check_cls_split(torch, device, b=1),
        "ln_quant_rows": check_row_quant(
            torch, "ln_quant_rows", Q.ln_quant_rows, [(Q._ln_quant_rows_plain, *ROW_QUANT_TIGHT)],
            [(m, VIT_WIDTH) for m in rows], LN_QUANT_OPS_PER_ELEM, ln_args),
        "gelu_quant_rows": check_row_quant(
            torch, "gelu_quant_rows", Q.gelu_quant_rows,
            [(Q._gelu_quant_rows_as_plain, *ROW_QUANT_TIGHT),
             (Q._gelu_quant_rows_plain, *ROW_QUANT_EXACT_ERF)],
            [(m, VIT_MLP) for m in rows], GELU_QUANT_OPS_PER_ELEM, gelu_args),
    }


def tree_to(tree, device):
    """A copy of a nested dict/list of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def phase_attack_surrogates(torch, card, device):
    """14.2: each of the YAML's five surrogates at full width, seeded on the
    card as the agent seeds them: one 448-px image's embedding on the card
    against the CPU's (same weights), the gradient of the loss toward a
    target image's embedding on both (the share of signs that agree), the
    card's milliseconds a PGD step (forward + backward, resize and
    normalization included) and the peak memory with all five resident."""
    import numpy as np

    from certifiedgpt_tpu_torch.attack import agent as AG
    from certifiedgpt_tpu_torch.attack import attack as AT

    rng = np.random.RandomState(ATTACK_SEED)
    x_cpu = torch.from_numpy(rng.rand(1, *IMAGE_HWC).astype(np.float32))
    t_cpu = torch.from_numpy(rng.rand(1, *IMAGE_HWC).astype(np.float32))
    x, target = x_cpu.to(device), t_cpu.to(device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    per_step, kept, graphed = {}, [], {}
    for i, name in enumerate(ATTACK_BACKBONES):
        cfg, apply_fn, init_fn = AG._BACKBONES[name]()
        params = init_fn(1000 + i, cfg, device)
        size = getattr(cfg, "image_size", None) or cfg.img_size
        enc = AT.SurrogateEncoder(name, lambda p, imgs, f=apply_fn, c=cfg: f(p, c, imgs),
                                  params, size)
        cpu_params = tree_to(params, "cpu")
        n_params = tree_numel(params)
        emb = AT.embed_images([enc], {name: params}, x)[name]
        emb_cpu = AT.embed_images([enc], {name: cpu_params}, x_cpu)[name]
        tgt = AT.embed_images([enc], {name: params}, target)
        tgt_cpu = AT.embed_images([enc], {name: cpu_params}, t_cpu)
        grads = []
        for px, p, tg in ((x, params, tgt), (x_cpu, cpu_params, tgt_cpu)):
            with AT.exact_f32(), torch.enable_grad():
                xg = px.clone().requires_grad_(True)
                (grad,) = torch.autograd.grad(AT.ensemble_loss([enc], xg, {name: p}, tg), xg)
            grads.append(grad)
        erel = rel_err(emb.cpu(), emb_cpu)
        share = float((torch.sign(grads[0].cpu()) == torch.sign(grads[1])).float().mean())
        attack = AT.make_pgd_attack([enc], 8.0 / 255.0, 1.0 / 255.0, ATTACK_TIMED_STEPS)
        ms = cuda_ms(torch, lambda: attack({name: params}, x, tgt), iters=1, warmup=1)
        per_step[name] = ms / ATTACK_TIMED_STEPS
        # the same steps on four images at once: a step that takes about as
        # long is bound by its launches, not by the card's work
        x4 = x.expand(4, -1, -1, -1).contiguous()
        tgt4 = {name: tgt[name].expand(4, -1).contiguous()}
        ms4 = cuda_ms(torch, lambda: attack({name: params}, x4, tgt4), iters=1, warmup=1)
        # 19(e): the replayed step against the eager loop, bit for bit
        eager = {}
        for b, px, tg in ((1, x, tgt), (4, x4, tgt4)):
            got, want = attack({name: params}, px, tg), attack({name: params}, px, tg,
                                                              cuda_graph=False)
            if not torch.equal(got, want):
                fail(f"19(e) {name}: the replayed PGD's pixels at {b} image(s) differ from the "
                     f"eager loop's in {int((got != want).sum())} of {got.numel()}")
            eager[b] = cuda_ms(torch, lambda: attack({name: params}, px, tg, cuda_graph=False),
                               iters=1, warmup=0) / ATTACK_TIMED_STEPS
        graphed[name] = {"ms_1": per_step[name], "ms_4": ms4 / ATTACK_TIMED_STEPS,
                         "eager_ms_1": eager[1], "eager_ms_4": eager[4]}
        log(f"[attack] 14.2 {name}: {n_params / 1e6:.1f} M f32 parameters at {size} px; "
            f"embedding on the card vs the CPU: relative error {erel:.3e}; loss gradient signs "
            f"agreeing {share:.6f}; {per_step[name]:.3f} ms a PGD step (forward + backward, "
            f"{ATTACK_TIMED_STEPS} steps timed), {ms4 / ATTACK_TIMED_STEPS:.3f} ms a step "
            f"on 4 images")
        log(f"[graph] 19(e) {name}: x_adv after {ATTACK_TIMED_STEPS} steps replayed from the "
            f"graph bit for bit the eager loop's at 1 and 4 images; ms a step replayed / eager: "
            f"{per_step[name]:.3f} / {eager[1]:.3f} (1 image), {ms4 / ATTACK_TIMED_STEPS:.3f} / "
            f"{eager[4]:.3f} (4 images); {card}")
        if not erel < SURROGATE_EMBED_REL_LIMIT or not share >= SURROGATE_SIGN_SHARE \
                or not bool(torch.isfinite(grads[0]).all()):
            fail(f"14.2 {name}: the card's surrogate disagrees with the CPU's "
                 f"(embedding {erel:.3e}, signs {share:.6f})")
        kept.append(params)
        del cpu_params, emb_cpu, tgt_cpu, grads
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    xr = x.clone().requires_grad_(True)

    def resize_step():
        with torch.enable_grad():
            torch.autograd.grad(AT._normalize(AT._resize(xr, 224)).sum(), xr)

    log(f"[attack] 14.2: the 448 -> 224 resize and normalization, forward + backward: "
        f"{cuda_ms(torch, resize_step, iters=20):.4f} ms a step")
    log(f"[graph] 19(e) ms a PGD step {json.dumps(graphed)}; {card}")
    log(f"[attack] 14.2: ms a PGD step {json.dumps({k: round(v, 4) for k, v in per_step.items()})}; "
        f"the five surrogates {(torch.cuda.memory_allocated() - base) / 1e9:.2f} GB resident, "
        f"peak {peak:.2f} GB over them; {card}")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    return per_step


def clip_tokenizer_files(path) -> int:
    """A CLIP BPE tokenizer with no merges (``vocab.json``, ``merges.txt``,
    ``tokenizer_config.json``): the 256 byte characters, the same with
    ``</w>``, then ``<|startoftext|>`` and ``<|endoftext|>`` (pad = EOT = the
    highest id, so the text tower pools at the first EOT). Returns its size."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    extra = [b for b in range(256) if b not in bs]
    chars = [chr(c) for c in bs] + [chr(256 + n) for n in range(len(extra))]
    vocab = chars + [c + "</w>" for c in chars] + ["<|startoftext|>", "<|endoftext|>"]
    (path / "vocab.json").write_text(json.dumps({t: i for i, t in enumerate(vocab)}))
    (path / "merges.txt").write_text("#version: 0.2\n")
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>",
        "eos_token": "<|endoftext|>", "unk_token": "<|endoftext|>",
        "pad_token": "<|endoftext|>", "model_max_length": 77}))
    return len(vocab)


class SeededTensors:
    """Seeded f32 tensors drawn on the card, by name: norm weights 1 + noise,
    matrices std 1/sqrt(fan-in), anything else std 0.02; ``kept`` holds the
    host copies of the names ``keep`` lists."""

    def __init__(self, torch, device, seed, keep=()):
        self.torch, self.device, self.keep = torch, device, set(keep)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.kept = {}

    def __call__(self, name, shape, dtype=None):
        torch = self.torch
        t = torch.randn(shape, generator=self.gen, device=self.device)
        if name.endswith("weight") and any(n in name for n in ("norm", ".bn", "downsample.1")):
            t = 1.0 + 0.02 * t
        elif name.endswith("running_var"):
            t = 1.0 + 0.1 * t.abs()
        elif len(shape) >= 2 and "embedding" not in name:
            t = t * math.prod(shape[1:]) ** -0.5
        else:
            t = t * 0.02
        if name in self.keep:
            self.kept[name] = t.cpu()
        return t


def write_clip_dir(torch, device, path):
    """A full-width HF ViT-B/32 CLIP directory from a seed: ``config.json``
    (the vision block's patch; the text block left to CLIP's defaults),
    ``model.safetensors`` (f32, ``CLIPModel``'s keys, written by
    ``write_safetensors``) and the synthesized tokenizer. Returns the
    seeded tensors (with the kept ones)."""
    c = CLIP_VIT_B32
    path.mkdir()
    specs = [("logit_scale", (), torch.float32)]

    def tower(prefix, d, inter, layers):
        for i in range(layers):
            p = f"{prefix}.encoder.layers.{i}."
            for m in ("q_proj", "k_proj", "v_proj", "out_proj"):
                specs.extend([(p + f"self_attn.{m}.weight", (d, d), torch.float32),
                              (p + f"self_attn.{m}.bias", (d,), torch.float32)])
            specs.extend([(p + "mlp.fc1.weight", (inter, d), torch.float32),
                          (p + "mlp.fc1.bias", (inter,), torch.float32),
                          (p + "mlp.fc2.weight", (d, inter), torch.float32),
                          (p + "mlp.fc2.bias", (d,), torch.float32)])
            for n in ("layer_norm1", "layer_norm2"):
                specs.extend([(p + f"{n}.weight", (d,), torch.float32),
                              (p + f"{n}.bias", (d,), torch.float32)])

    d, td = c["hidden"], c["text_hidden"]
    specs += [("vision_model.embeddings.class_embedding", (d,), torch.float32),
              ("vision_model.embeddings.patch_embedding.weight", (d, 3, c["patch"], c["patch"]),
               torch.float32),
              ("vision_model.embeddings.position_embedding.weight", (c["positions"], d),
               torch.float32)]
    for n in ("pre_layrnorm", "post_layernorm"):
        specs += [(f"vision_model.{n}.weight", (d,), torch.float32),
                  (f"vision_model.{n}.bias", (d,), torch.float32)]
    tower("vision_model", d, c["inter"], c["layers"])
    specs += [("visual_projection.weight", (c["proj"], d), torch.float32),
              ("text_model.embeddings.token_embedding.weight", (c["vocab"], td), torch.float32),
              ("text_model.embeddings.position_embedding.weight", (c["text_positions"], td),
               torch.float32),
              ("text_model.final_layer_norm.weight", (td,), torch.float32),
              ("text_model.final_layer_norm.bias", (td,), torch.float32),
              ("text_projection.weight", (c["proj"], td), torch.float32)]
    tower("text_model", td, c["text_inter"], c["text_layers"])
    make = SeededTensors(torch, device, ATTACK_SEED, keep=(
        "visual_projection.weight", "vision_model.encoder.layers.11.mlp.fc2.weight",
        "text_projection.weight"))
    size = write_safetensors(torch, path / "model.safetensors", specs,
                             lambda name, shape, dtype: make(name, shape))
    (path / "config.json").write_text(json.dumps({
        "architectures": ["CLIPModel"], "model_type": "clip", "projection_dim": c["proj"],
        "text_config": {}, "vision_config": {"patch_size": c["patch"]}}))
    vocab = clip_tokenizer_files(path)
    log(f"[attack] 14.3: wrote {path.name}: model.safetensors {size / 1e9:.3f} GB "
        f"({len(specs)} tensors), config.json, a CLIP tokenizer of {vocab} ids")
    return make


def openai_resnet_shapes(cfg):
    """(key, shape) of every tensor of an OpenAI CLIP ``visual.*`` ResNet
    state dict at ``cfg``'s widths (``torch.save`` of its
    ``ModifiedResNet``: convs, BatchNorm with running statistics and
    ``num_batches_tracked`` (shape None), the attention pool)."""
    shapes = []

    def conv(key, cout, cin, k):
        shapes.append((key + ".weight", (cout, cin, k, k)))

    def bn(key, ch):
        shapes.extend((f"{key}.{leaf}", (ch,))
                      for leaf in ("weight", "bias", "running_mean", "running_var"))
        shapes.append((key + ".num_batches_tracked", None))

    w = cfg.width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w)), 1):
        conv(f"visual.conv{i}", cout, cin, 3)
        bn(f"visual.bn{i}", cout)
    cin = w
    for stage, blocks in enumerate(cfg.layers):
        planes = w * 2 ** stage
        for b in range(blocks):
            base = f"visual.layer{stage + 1}.{b}"
            conv(base + ".conv1", planes, cin, 1)
            bn(base + ".bn1", planes)
            conv(base + ".conv2", planes, planes, 3)
            bn(base + ".bn2", planes)
            conv(base + ".conv3", planes * 4, planes, 1)
            bn(base + ".bn3", planes * 4)
            if b == 0:  # stride 2, or the first stage's change of width
                conv(base + ".downsample.0", planes * 4, cin, 1)
                bn(base + ".downsample.1", planes * 4)
            cin = planes * 4
    embed = w * 32
    shapes.append(("visual.attnpool.positional_embedding",
                   ((cfg.image_size // 32) ** 2 + 1, embed)))
    for proj, out in (("q_proj", embed), ("k_proj", embed), ("v_proj", embed),
                      ("c_proj", cfg.embed_dim)):
        shapes += [(f"visual.attnpool.{proj}.weight", (out, embed)),
                   (f"visual.attnpool.{proj}.bias", (out,))]
    return shapes


def write_rn50(torch, device, path):
    """``RN50.pt`` in the OpenAI ``visual.*`` layout from a seed (a plain
    ``torch.save`` state dict at RN50's widths). Returns the seeded
    tensors."""
    from certifiedgpt_tpu_torch.attack.clip import ClipResNetConfig

    make = SeededTensors(torch, device, ATTACK_SEED + 1, keep=(
        "visual.attnpool.c_proj.weight", "visual.layer3.5.conv2.weight",
        "visual.layer4.0.downsample.1.running_var"))
    sd = {key: torch.tensor(0) if shape is None else make(key, shape).cpu()
          for key, shape in openai_resnet_shapes(ClipResNetConfig.rn50())}
    torch.save(sd, path)
    log(f"[attack] 14.3: wrote {path.name}: {len(sd)} tensors, "
        f"{os.path.getsize(path) / 1e6:.1f} MB")
    return make


def check_loaded_surrogates(torch, agent, clip_made, rn_made, clip_dir, rn_path, log_text):
    """The ViT-B/32 surrogate and RN50 hold the written tensors (transposed
    and permuted to the JAX layout) bit for bit; the text scorer is the CLIP
    tower; the log names each load."""
    from certifiedgpt_tpu_torch.attack import agent as AG

    enc = {e.name: e.params for e in agent.encoders}
    vit, rn = enc["vit_b32"], enc["rn50"]
    k = clip_made.kept
    pairs = [(vit["proj"], k["visual_projection.weight"].T),
             (vit["layers"][11]["fc2"]["kernel"], k["vision_model.encoder.layers.11.mlp.fc2.weight"].T)]
    k = rn_made.kept
    pairs += [(rn["attnpool"]["proj"]["kernel"], k["visual.attnpool.c_proj.weight"].T),
              (rn["layer3"][5]["conv2"]["kernel"], k["visual.layer3.5.conv2.weight"].permute(2, 3, 1, 0)),
              (rn["layer4"][0]["downsample"]["bn"]["var"], k["visual.layer4.0.downsample.1.running_var"])]
    for got, want in pairs:
        if not torch.equal(got.cpu(), want.contiguous()):
            fail("14.3: a loaded surrogate leaf differs from the written tensor")
    if isinstance(agent.text_encoder, AG._HashTextEncoder):
        fail("14.3: the CLIP text encoder did not load from the written directory")
    for line in (f"Loaded vit_b32 weights from {clip_dir}", f"Loaded rn50 weights from {rn_path}",
                 f"CLIP text encoder loaded from {clip_dir}"):
        if line not in log_text:
            fail(f"14.3: certified.log lacks {line!r}")
    for name in ("rn101", "vit_b16", "vit_l14"):
        if f"attack backbone {name} is running on RANDOM weights" not in log_text:
            fail(f"14.3: no random-weights warning for {name}")
    return len(pairs)


def check_attack_outputs(label, out, rows, summary, n_rows, backbones, sigmas, epsilon):
    if len(rows) != n_rows or any(set(r) != ATTACK_ROW_KEYS for r in rows):
        fail(f"{label}: {len(rows)} rows, not {n_rows} with the JAX package's keys")
    for row in rows:
        if not 0.0 <= row["linf"] <= epsilon + 1e-6 or row["sigma"] not in sigmas \
                or row["backbone"] not in backbones \
                or not all(math.isfinite(row[k]) for k in ("clean_similarity", "adv_similarity")):
            fail(f"{label}: malformed row {row}")
    on_disk = json.loads((out / "attack_summary.json").read_text())
    if json.dumps(on_disk, sort_keys=True) != json.dumps(summary, sort_keys=True) \
            or summary["total"] != n_rows \
            or set(summary["success_rate_per_backbone"]) != set(backbones):
        fail(f"{label}: summary {summary} does not match its rows")
    csv_rows = (out / "attack_ancova.csv").read_text().splitlines()
    if len(csv_rows) != n_rows + 1:
        fail(f"{label}: attack_ancova.csv has {len(csv_rows)} lines")


def phase_attack(torch, card, device, d_in: int, d_out: int):
    """14.3: ``launch.main`` in ``attack`` mode on ``vqav2_attack.yaml``
    unchanged over ``ATTACK_IMAGES`` written images (full-width W8A8
    victim from its seed, 100 PGD steps for each of five backbones, four
    sigmas), ``CLIP_HF_DIR``/``CLIP_VIT_B32`` at a written full-width
    ViT-B/32 directory and ``CLIP_RN50`` at a written ``RN50.pt``, the other
    checkpoint variables where nothing exists. 14.4: a copy whose run block
    has one backbone (vit_b32), sigma 0.5 and the RGF stage (2 queries, 1
    iteration) over one image. Checks rows, files, the loads, the launches
    a caption and the caption streams; prints seconds per attacked image
    split into each backbone's PGD and the captions. Returns 14.3's
    launches."""
    import tempfile
    from pathlib import Path
    from unittest import mock

    from certifiedgpt_tpu_torch.attack import agent as AG
    from certifiedgpt_tpu_torch.common.config import Config

    model_block = Config(ATTACK_CONFIG).to_dict()["model"]
    if {k: model_block.get(k) for k in CERTIFY_MODEL_BLOCK} != CERTIFY_MODEL_BLOCK:
        fail(f"{ATTACK_CONFIG}: the model block is not the certify configs' ({model_block})")
    run_cfg = Config(ATTACK_CONFIG).run
    sigmas = [float(s) for s in run_cfg.get("sigma_grid")]
    epsilon = float(run_cfg.get("attack_epsilon"))
    backbones = list(run_cfg.get("attack_backbones"))
    if tuple(backbones) != ATTACK_BACKBONES:
        fail(f"{ATTACK_CONFIG} names backbones {backbones}, not {ATTACK_BACKBONES}")
    timing = {"pgd": {}, "caption": [], "streams": [], "agents": []}
    transfer, caption, run = (AG.AttackAgent._transfer_attack, AG.AttackAgent.caption,
                              AG.AttackAgent.run)

    def timed_transfer(self, attack, pixels, target_pixels, enc):
        t0 = time.perf_counter()
        out = transfer(self, attack, pixels, target_pixels, enc)  # numpy: synchronized
        timing["pgd"].setdefault(enc.name, []).append(time.perf_counter() - t0)
        return out

    def timed_caption(self, pixels, instruction, stream, sigma=None):
        t0 = time.perf_counter()
        out = caption(self, pixels, instruction, stream, sigma)  # a string: synchronized
        timing["caption"].append(time.perf_counter() - t0)
        timing["streams"].append(tuple(stream))
        return out

    def timed_run(self):
        timing["agents"].append(self)
        t0 = time.perf_counter()
        out = run(self)
        timing["run_s"] = time.perf_counter() - t0
        return out

    patches = [mock.patch.object(AG.AttackAgent, "_transfer_attack", timed_transfer),
               mock.patch.object(AG.AttackAgent, "caption", timed_caption),
               mock.patch.object(AG.AttackAgent, "run", timed_run)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_attack_") as tmp, \
            contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        root = Path(tmp)
        env, proj = launch_files(root, ATTACK_IMAGES, d_in, d_out)
        t0 = time.perf_counter()
        clip_dir, rn_path = root / "clip-vit-base-patch32", root / "RN50.pt"
        clip_made = write_clip_dir(torch, device, clip_dir)
        rn_made = write_rn50(torch, device, rn_path)
        log(f"[attack] 14.3: the two surrogate files written in {time.perf_counter() - t0:.3f} s")
        env.update({"CLIP_HF_DIR": str(clip_dir), "CLIP_VIT_B32": str(clip_dir),
                    "CLIP_RN50": str(rn_path),
                    **{k: str(root / "absent" / k.lower())
                       for k in ("CLIP_VIT_B16", "CLIP_VIT_L14", "CLIP_RN101")}})
        out = root / "out_attack"
        res = run_launch(torch, ["attack", "--config-path", ATTACK_CONFIG], env, out)
        rows = read_rows(out / "attack_results.jsonl")
        summary = res["summary"]
        n_rows = ATTACK_IMAGES * len(backbones) * len(sigmas)
        check_attack_outputs("14.3", out, rows, summary, n_rows, backbones, sigmas, epsilon)
        grid = summary.get("success_rate_grid", {})
        if set(summary) != ATTACK_SUMMARY_KEYS or set(grid) != set(backbones) \
                or any(set(cells) != {str(s) for s in sigmas} or None in cells.values()
                       for cells in grid.values()) \
                or len(summary["ancova"]["coefficients"]) != 2 + 2 * (len(backbones) - 1):
            fail(f"14.3: summary {summary} lacks the grid or the ANCOVA")
        if max(r["linf"] for r in rows) < epsilon - 1.5 / 255:
            fail("14.3: the PGD did not reach the l-inf budget")
        captions = ATTACK_IMAGES * len(sigmas) * (1 + len(backbones))
        if len(timing["caption"]) != captions:
            fail(f"14.3: {len(timing['caption'])} captions, expected {captions}")
        check_projection("14.3", res["seen"], proj, captions)
        check_counts("launch attack", res["launches"], PER_CHUNK["flash_cls"], captions,
                     res["decode_steps"])
        pgd = {name: sum(v) / ATTACK_IMAGES for name, v in timing["pgd"].items()}
        cap_s = sum(timing["caption"]) / ATTACK_IMAGES
        per_image = timing["run_s"] / ATTACK_IMAGES
        log_text = (out / "certified.log").read_text()
        loaded = check_loaded_surrogates(torch, timing["agents"][0], clip_made, rn_made,
                                         clip_dir, rn_path, log_text)
        log(f"[attack] 14.3 {ATTACK_CONFIG}: {len(rows)} rows, linf max "
            f"{max(r['linf'] for r in rows) * 255:.3f}/255; success_rate_grid "
            f"{json.dumps(grid)}; ancova sigma {json.dumps(summary['ancova']['coefficients']['sigma'])}; "
            f"{loaded} loaded leaves equal the written tensors; launches "
            f"{json.dumps(res['launches'])} over {captions} captions")
        log(f"[attack] 14.3: {per_image:.3f} s per attacked image (the agent's run "
            f"{timing['run_s']:.3f} s over {ATTACK_IMAGES} images): PGD "
            f"{json.dumps({k: round(v, 3) for k, v in pgd.items()})} s "
            f"({sum(pgd.values()):.3f} s, {len(backbones)} x {int(run_cfg.get('attack_steps'))} "
            f"steps), {captions // ATTACK_IMAGES} captions {cap_s:.3f} s "
            f"({cap_s * ATTACK_IMAGES / captions:.4f} s a caption), other "
            f"{per_image - sum(pgd.values()) - cap_s:.3f} s; model build {res['build_s']:.3f} s, "
            f"CLI wall {res['wall']:.3f} s; {res['decode_steps']} decode steps launched; peak "
            f"memory {res['peak_gb']:.2f} GB; {card}; card during the run: {res['card_state']}")
        check_caption_kernels(torch, card, timing["agents"][0])
        counted = res["launches"]
        del res
        timing.update(pgd={}, caption=[], streams=[], agents=[])
        gc.collect()
        torch.cuda.empty_cache()

        # 14.4: the RGF query stage on the card
        cfg = config_with_run(ATTACK_CONFIG, root / "attack_rgf.yaml", attack_backbones=["vit_b32"],
                              sigma_grid=[0.5], rgf_queries=2, rgf_iters=1, max_images=1)
        out = root / "out_rgf"
        res = run_launch(torch, ["attack", "--config-path", str(cfg)], env, out)
        rows = read_rows(out / "attack_results.jsonl")
        check_attack_outputs("14.4", out, rows, res["summary"], 1, ["vit_b32"], [0.5], epsilon)
        want = [(0, 0), (2, 0, 0, 0, 1), (2, 0, 0, 0, 2), (2, 0, 0, 0, 3), (1, 0, 0)]
        if timing["streams"] != want:
            fail(f"14.4: caption streams {timing['streams']}, expected {want}")
        check_counts("launch attack rgf", res["launches"], PER_CHUNK["flash_cls"], len(want),
                     res["decode_steps"])
        log(f"[attack] 14.4 RGF (vit_b32, sigma 0.5, 2 queries, 1 iteration): row "
            f"{json.dumps(rows[0])}; {len(want)} captions {sum(timing['caption']):.3f} s, PGD "
            f"{sum(timing['pgd']['vit_b32']):.3f} s, the agent's run {timing['run_s']:.3f} s; "
            f"launches {json.dumps(res['launches'])}; {card}")
        del res, timing["agents"]
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def check_caption_kernels(torch, card, agent):
    """14.3 (end), on 14.3's agent (the full-width W8A8 victim): one caption
    at batch 1 through the kernels and through their plain versions on the
    same seeded pixels and noise stream. The image tokens must agree within
    the attention's relative limit, and the first decode step's logits must
    move from the plain path's by at most ``CAPTION_LOGIT_FACTOR`` times
    what a random change of the plain image tokens of the same size moves
    them (the random-weight W8A8 decoder turns a 1 % change of its input
    into different greedy tokens, as phase 11 found, so token equality is
    held only on the tiny model, ``tests/test_torch_attack_gpu.py``). The
    kernels must run once a layer a ViT forward (39 / 156 / 78)."""
    from unittest import mock

    import numpy as np

    from certifiedgpt_tpu_torch.attack.attack import _resize
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_gen_batch
    from certifiedgpt_tpu_torch.models import minigpt4 as M
    from certifiedgpt_tpu_torch.models.llama import lm_head_logits

    rng = np.random.RandomState(ATTACK_SEED)
    pixels = rng.rand(*IMAGE_HWC).astype(np.float32)
    params, cfg, device = agent.model.params, agent.model.cfg, agent.device
    mean, std = agent._pixel_stats()
    image = _resize(torch.from_numpy((pixels - mean) / std)[None].to(device), cfg.vit.img_size)
    prompt = build_gen_batch(agent.model.tokenizer, [QUESTION],
                             BatchSpec(seq_len=agent.seq_len, num_img_tokens=cfg.num_img_tokens))
    batch = {k: torch.from_numpy(v).long().to(device) for k, v in prompt.items()}
    batch["image"] = image
    victim = agent._victim_generate
    tokens = []

    def recording(*args):
        out = victim(*args)
        tokens.append(out.cpu())
        return out

    def first_logits(feats):
        with mock.patch.object(M, "encode_img", lambda *a, **k: feats):
            return lm_head_logits(params["llama"], M.prefill(params, cfg, batch, 1)[0])

    agent._victim_generate = recording
    try:
        with torch.no_grad():
            reset_counts()
            agent.caption(pixels, QUESTION, (0, 0), 0.5)
            torch.cuda.synchronize()
            launches = read_counts()
            steps = decode_steps()
            feats = M.encode_img(params, cfg, image)
            with contextlib.ExitStack() as stack:
                for p in plain_versions():
                    stack.enter_context(p)
                agent.caption(pixels, QUESTION, (0, 0), 0.5)
                plain = M.encode_img(params, cfg, image)
                noise = torch.randn(plain.shape, generator=torch.Generator(device=device)
                                    .manual_seed(ATTACK_SEED), device=device)
                control = plain + (noise * (feats - plain).float().norm() / noise.norm()).to(
                    plain.dtype)
                logits = [first_logits(f) for f in (feats, plain, control)]
    finally:
        agent._victim_generate = victim
    err = rel_err(feats, plain)
    dev_k, dev_c = rel_err(logits[0], logits[1]), rel_err(logits[2], logits[1])
    same = [int(a != b) for a, b in zip(tokens[0][0].tolist(), tokens[1][0].tolist())]
    log(f"[attack] 14.3 a caption at batch 1 (full width, W8A8, sigma 0.5) through the kernels "
        f"vs their plain versions: image tokens relative error {err:.3e}; first-step logits "
        f"{dev_k:.3e} apart (a random change of the plain image tokens as large: {dev_c:.3e}); "
        f"greedy tokens {tokens[0][0].tolist()} vs {tokens[1][0].tolist()} ({sum(same)} of "
        f"{len(same)} differ); launches {json.dumps(launches)}; {card}")
    check_counts("14.3 caption", launches, PER_CHUNK["flash_cls"], 1, steps)
    if not err < ATTN_REL_LIMIT or not dev_k <= CAPTION_LOGIT_FACTOR * dev_c:
        fail("14.3: the caption through the kernels disagrees with the plain versions'")


# ----------------------------------------------------------------------
# phase 15: run.distributed at world size 1, the profiler, the stage split
# ----------------------------------------------------------------------
# a trace window of about one certify chunk (2.7-2.8 s a chunk in phase 8)
PROFILE_WINDOW_MS = 3000
# 15.2's stages: the clock names of the certify path (ViT and Q-Former are
# encode_img)
STAGE_NAMES = ("noise", "vit", "qformer", "prefill", "decode", "host_labels")
ELEMENTWISE = "other elementwise / copy"


def phase15_worker(spec_json: str) -> int:
    """One rank of ``torch.distributed.run``: ``launch.main`` on the
    spec's argv with the launch counters reset just before and read just
    after; writes the summary, the wall seconds, the launches and the
    decode steps to the spec's result file."""
    import torch

    from certifiedgpt_tpu_torch import launch
    from certifiedgpt_tpu_torch.models import minigpt4 as M

    spec = json.loads(spec_json)
    reset_counts()
    M.generate.decode_steps = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = launch.main(spec["argv"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(spec["result"], "w") as handle:
        json.dump({"summary": summary, "wall": wall, "launches": read_counts(),
                   "decode_steps": M.generate.decode_steps,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}, handle)
    return 0


def phase_distributed(torch, card, d_in: int, d_out: int, serial_rows):
    """15.1: phase 8's certify run again on the same written files (the
    shipped ``vqav2_certify_noise_0.5.yaml`` at full width, ``max_images``
    1), with ``run.distributed`` (NCCL, world size 1: the token gather of
    every chunk runs through the batch group; a model group of one leaves
    the decoder unsplit) and ``enable_profile`` (image 0, a window of about
    one chunk), through ``python -m torch.distributed.run --nproc_per_node
    1``.
    Its row (label, radius, draws) must equal phase 8's first certify row;
    the trace must be written and hold CUDA kernel events; each path kernel
    launched its launches a chunk. Returns the launches."""
    import re
    import tempfile
    from pathlib import Path
    from unittest import mock

    from certifiedgpt_tpu_torch.agents import certify as A
    from certifiedgpt_tpu_torch.common.config import Config

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        root = Path(tmp)
        env, _ = launch_files(root, LAUNCH_IMAGES, d_in, d_out)
        out, logdir = root / "out_dist", root / "trace"
        env["OUTPUT_DIR"] = str(out)
        with mock.patch.dict(os.environ, env):
            cfg = Config(LAUNCH_RUNS[0][1]).to_dict()
        cfg["run"].update(distributed=True, max_images=1, enable_profile=True, profile_step=0,
                          duration_ms=PROFILE_WINDOW_MS, profile_logdir=str(logdir),
                          output_dir=str(out))
        path = root / "certify_distributed.yaml"
        path.write_text(json.dumps(cfg))  # JSON is YAML
        spec = {"argv": ["certify", "--config-path", str(path), "--device", "cuda"],
                "result": str(root / "worker.json")}
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", os.path.abspath(__file__), "--phase15-worker",
               json.dumps(spec)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=dict(os.environ, **env), capture_output=True,
                              text=True, timeout=600)
        command_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"15.1: torch.distributed.run exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        res = json.loads((root / "worker.json").read_text())
        rows = read_rows(out / "certify_results.jsonl")
        log_text = (out / "certified.log").read_text()
        knobs = A.SmoothingKnobs.from_run(cfg["run"])
        check_certify_rows("15.1", rows, "certify", 1, knobs.n0 + knobs.n, knobs.sigma)
        row, want = rows[0], serial_rows["certify"][0]
        log(f"[dist] certify row {json.dumps(row)}")
        if "rank 0 of 1 (nccl)" not in log_text:
            fail("15.1: certified.log does not show an NCCL group of one rank")
        if (row["label"], row["radius"], row["draws"]) != \
                (want["label"], want["radius"], want["draws"]):
            fail(f"15.1: row {row} differs from phase 8's first certify row {want}")
        chunks = dispatched_chunks(row, knobs.n0, knobs.n, knobs.mc_batch,
                                   knobs.dispatch_window)
        check_counts("15.1 certify distributed", res["launches"], PER_CHUNK["flash_cls"], chunks,
                     res["decode_steps"])
        trace = logdir / "trace_rank0_epoch0_step0.json"
        if not trace.exists():
            fail(f"15.1: no trace at {trace}")
        events = json.loads(trace.read_text()).get("traceEvents", [])
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        if kernels == 0:
            fail("15.1: the trace holds no CUDA kernel events")
        log(f"[dist] trace {trace.name}: {trace.stat().st_size} bytes, {len(events)} events, "
            f"{kernels} CUDA kernel events (window {PROFILE_WINDOW_MS} ms)")
        export = re.search(r"profiler trace stopped: .* \(stop and export ([0-9.]+) s\)", log_text)
        if export is None:
            fail("15.1: certified.log has no profiler stop line")
        export_s = float(export.group(1))
        log(f"[dist] the trace's stop and export took {export_s:.3f} s inside the row's seconds; "
            f"without it {row['seconds'] - export_s:.3f} s "
            f"({(row['seconds'] - export_s) / want['seconds']:.3f}x phase 8's)")
        log(f"[dist] certify through torch.distributed.run (NCCL, world size 1, profiler on): "
            f"{row['seconds']:.3f} s for the certified image against {want['seconds']:.3f} s "
            f"for the same image in phase 8 ({row['seconds'] / want['seconds']:.3f}x); "
            f"launch.main {res['wall']:.3f} s, command {command_s:.3f} s; {chunks} chunks "
            f"dispatched; {res['decode_steps']} decode steps; peak memory "
            f"{res['peak_gb']:.2f} GB; launches {json.dumps(res['launches'])}; {card}")
    return res["launches"]


class ProfiledStages:
    """A stage clock for the certify path whose every stage runs under its
    own ``torch.profiler`` context (CUDA activity): device seconds summed
    by stage and by ``PROFILE_GROUPS``, and each stage's wall seconds."""

    def __init__(self, torch):
        self.torch = torch
        self.groups = {}
        self.wall = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name):
        from certifiedgpt_tpu_torch.ops import cuda_kernels

        torch = self.torch
        with cuda_kernels.device_trace() as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            self.wall[name] = self.wall.get(name, 0.0) + time.perf_counter() - t0
        groups = self.groups.setdefault(name, {})
        for e in cuda_kernels.device_events(prof.key_averages()):
            if e.self_device_time_total <= 0:
                continue
            key = e.key.lower()
            group = next((g for g, keys in PROFILE_GROUPS if any(k in key for k in keys)),
                         ELEMENTWISE)
            groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e6

    def count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n


def phase_stage_split(torch, card, device):
    """15.2: one certify chunk of the main path (the shipped knobs, 96
    draws) with every stage under ``torch.profiler``: the device seconds of
    ``encode_img`` (ViT, Q-Former), the prefill and the decode, each split
    by kernel group, and the elementwise/copy seconds of each stage."""
    import numpy as np

    from certifiedgpt_tpu_torch.agents.certify import SmoothingKnobs
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
    from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary, make_sample_fn

    t0 = time.perf_counter()
    model = MiniGPT4Model.from_config(CERTIFY_MODEL_BLOCK, device)
    torch.cuda.synchronize()
    log(f"[stages] built the full-width model in {time.perf_counter() - t0:.1f} s")
    knobs = SmoothingKnobs.from_run(RUN_CFG)
    vocab = AnswerVocabulary(GT_ANSWERS)
    image = np.random.RandomState(0).randn(*IMAGE_HWC).astype(np.float32)

    def chunk(clock):
        fn = make_sample_fn(model, QUESTION, vocab, knobs.sigma, mc_batch=MC_BATCH,
                            max_new_tokens=knobs.max_new_tokens, seq_len=knobs.seq_len,
                            early_exit=knobs.early_exit, clock=clock, window=1)
        return fn(image, MC_BATCH, seed=0)

    # the chunk with the decoder's fused elementwise kernels and the W8A8
    # GEMM kernel, then with the pair the GEMM replaced (phase 21), then with
    # the chains the elementwise kernels replaced (phase 20), each after a
    # warm-up of its own (a capture of its own decode step)
    for form, patches in (("kernels", []), ("pair", pair_versions(torch)),
                          ("chains", chain_versions())):
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            chunk(None)  # warm-up
            clock = ProfiledStages(torch)
            labels = chunk(clock)
        if len(labels) != MC_BATCH:
            fail(f"15.2: {len(labels)} labels for a chunk of {MC_BATCH}")
        total = sum(sum(g.values()) for g in clock.groups.values())
        if total <= 0:
            fail("15.2: the profiler saw no device time")
        for name in STAGE_NAMES:
            groups = clock.groups.get(name, {})
            device_s = sum(groups.values())
            log(f"[stages] {form}: {name:11s} wall {clock.wall.get(name, 0.0):8.4f} s, device "
                f"{device_s:8.4f} s, elementwise/copy {groups.get(ELEMENTWISE, 0.0):8.4f} s; "
                + ", ".join(f"{g} {sec:.4f} s" for g, sec in sorted(groups.items(),
                                                                   key=lambda kv: -kv[1])))
        elementwise = {name: groups.get(ELEMENTWISE, 0.0) for name, groups in clock.groups.items()}
        split = {"encode_img": elementwise.get("vit", 0.0) + elementwise.get("qformer", 0.0),
                 "prefill": elementwise.get("prefill", 0.0),
                 "decode": elementwise.get("decode", 0.0)}
        log(f"[stages] {form}: one chunk of {MC_BATCH}: elementwise/copy device seconds by stage "
            f"{json.dumps({k: round(v, 4) for k, v in split.items()})} of "
            f"{sum(elementwise.values()):.4f} s; device total {total:.4f} s (prefill "
            f"{sum(clock.groups.get('prefill', {}).values()):.4f} s, decode "
            f"{sum(clock.groups.get('decode', {}).values()):.4f} s); decode steps "
            f"{clock.counts.get('decode_step', 0)}; {card}")
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# phase 17: the chat demo and the attack runbook, the port's twins of the
# JAX package's scripts/demo_chat.py and scripts/verify_attack.py
# ----------------------------------------------------------------------
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
DEMO_SCRIPT = "scripts/demo_chat_torch.py"
ATTACK_RUNBOOK = "scripts/verify_attack_torch.py"
CHAT_CONFIG = LAUNCH_RUNS[0][1]  # the shipped certify YAML, unchanged
# two short questions: with the byte-level tokenizer every character is a
# token, and the second turn's prompt carries the first turn's answer
CHAT_QUESTIONS = ("what is in this picture?", "what colour is it?")
CHAT_MAX_NEW_TOKENS = 20  # the demo's default
CHAT_TEMPLATE = "minigptv2"  # the demo's default
CLIP_ENV = ("CLIP_HF_DIR", "CLIP_VIT_B16", "CLIP_VIT_B32", "CLIP_VIT_L14", "CLIP_RN50",
            "CLIP_RN101")
SCRIPT_TIMEOUT_S = 300


def load_script(path):
    """A script under ``scripts/`` as a module."""
    import importlib.util

    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_script(root, label, argv, env, stdin_text=""):
    """``python <argv>`` from the repository's root with ``env`` added, its
    input from ``stdin_text`` and its output to files under ``root``."""
    (root / f"{label}.in").write_text(stdin_text)
    files = [open(root / f"{label}.in"), open(root / f"{label}.out", "w"),
             open(root / f"{label}.err", "w")]
    proc = subprocess.Popen([sys.executable, *argv], cwd=REPO_DIR, env=dict(os.environ, **env),
                            stdin=files[0], stdout=files[1], stderr=files[2])
    return {"label": label, "proc": proc, "files": files, "t0": time.perf_counter()}


def finish_scripts(root, started):
    """Waits for each started script (at most ``SCRIPT_TIMEOUT_S`` from its
    start); returns label -> (exit code, stdout, stderr, seconds until it
    was seen to end). One that outlives the limit is killed, and so are the
    others, and the phase fails."""
    done = {}
    try:
        for s in started:
            left = SCRIPT_TIMEOUT_S - (time.perf_counter() - s["t0"])
            try:
                rc = s["proc"].wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                fail(f"17: {s['label']} ran past {SCRIPT_TIMEOUT_S} s")
            done[s["label"]] = (rc, (root / f"{s['label']}.out").read_text(),
                                (root / f"{s['label']}.err").read_text(),
                                time.perf_counter() - s["t0"])
    finally:
        for s in started:
            if s["proc"].poll() is None:
                s["proc"].kill()
                s["proc"].wait()
            for f in s["files"]:
                f.close()
    return done


def read_report(path) -> dict:
    """A runbook's JSON report, or {} where it wrote none."""
    return json.loads(path.read_text()) if path.exists() else {}


def demo_answers(label, rc, out, err):
    """The two answers a demo run printed after ``bot>``: it must exit 0,
    print the image line, and prompt ``you> `` once a question and once at
    the end of its input."""
    if rc != 0:
        fail(f"17.1 {label}: the demo exited {rc}:\n{out[-2000:]}\n{err[-4000:]}")
    parts = out.split("you> ")
    bots = parts[1:-1]
    if not parts[0].startswith("Image loaded: ") or parts[-1] != "" \
            or len(bots) != len(CHAT_QUESTIONS) \
            or not all(p.startswith("bot> ") and p.endswith("\n") for p in bots):
        fail(f"17.1 {label}: the demo's output is not two bot> lines after the image line:\n"
             f"{out[-2000:]}")
    return [p[len("bot> "):-1] for p in bots]


def chat_turn(torch, chat, question, **stream):
    """One streamed turn: the pieces, the seconds to the first one and the
    seconds at each later one (``stream``: ``stream_answer``'s keywords)."""
    chat.ask(question)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pieces, stamps = [], []
    for piece in chat.stream_answer(max_new_tokens=CHAT_MAX_NEW_TOKENS, **stream):
        stamps.append(time.perf_counter() - t0)  # each piece read its token on the host
        pieces.append(piece)
    if not pieces:
        fail(f"17.2: no piece streamed for {question!r}")
    return pieces, stamps


def phase_chat(torch, card, demo, image_path, env):
    """17.2: the demo's chat in-process on one model (``build_chat`` on the
    shipped certify YAML): two streamed turns, the first with its kernel
    launches counted (a batch-1 chunk and its decode steps), and the first
    turn again through ``Chat.answer`` on a fresh conversation, which must
    give the stream's token ids and text (the byte-level tokenizer of a
    model without a Vicuna directory decodes only ids 4-259, so at random
    weights the text is mostly empty: the ids are the check). Returns the
    launches of the first turn."""
    from unittest import mock

    from PIL import Image

    from certifiedgpt_tpu_torch.data.text import strip_generation_markers

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env):
        chat = demo.build_chat(CHAT_CONFIG, CHAT_TEMPLATE, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the ids each decode is given: the stream decodes its growing id list,
    # the answer its ids up to EOS
    tok, decoded = chat.model.tokenizer, []
    decode = tok.decode

    def recording_decode(ids, skip_special_tokens=True):
        decoded.append([int(i) for i in ids])
        return decode(ids, skip_special_tokens=skip_special_tokens)

    tok.decode = recording_decode
    image = Image.open(image_path)
    chat.upload_img(image)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    pieces, stamps = chat_turn(torch, chat, CHAT_QUESTIONS[0])
    launches = read_counts()
    stream_ids = decoded[-1]
    # a decode step after every piece but the last, unless the budget ran
    # out, and the capture's warm-up step at the turn's first piece
    steps = len(pieces) - (len(pieces) == CHAT_MAX_NEW_TOKENS)
    if decode_steps() != steps + 1:
        fail(f"17.2: {decode_steps()} decode steps for {len(pieces)} pieces, want {steps} and "
             "the capture's warm-up")
    check_counts("17.2 chat turn", launches, PER_CHUNK["flash_cls"], 1, decode_steps())
    pieces2, stamps2 = chat_turn(torch, chat, CHAT_QUESTIONS[1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # 19(f): turn 1 again, replayed (captured by turn 1) and eager
    turn_s = {}
    for mode in ("graph", "eager"):
        again = demo.Chat(chat.model, chat.vis_processor, template=CHAT_TEMPLATE)
        again.upload_img(image)
        got, got_stamps = chat_turn(torch, again, CHAT_QUESTIONS[0], cuda_graph=mode == "graph")
        if decoded[-1] != stream_ids:
            fail(f"19(f): the chat turn's ids {mode} {decoded[-1]} are not turn 1's {stream_ids}")
        turn_s[mode] = (got_stamps[0], (got_stamps[-1] - got_stamps[0]) / max(len(got) - 1, 1))
    log(f"[graph] 19(f) a chat turn (batch 1, {len(pieces)} pieces): ids equal replayed and "
        f"eager; first piece after {turn_s['graph'][0]:.4f} s / {turn_s['eager'][0]:.4f} s, then "
        f"{turn_s['graph'][1]:.4f} s / {turn_s['eager'][1]:.4f} s a piece (replayed / eager); "
        f"{card}")
    streamed = chat.conv.messages[1][1]
    other = demo.Chat(chat.model, chat.vis_processor, template=CHAT_TEMPLATE)
    other.upload_img(image)
    other.ask(CHAT_QUESTIONS[0])
    t0 = time.perf_counter()
    answer = other.answer(max_new_tokens=CHAT_MAX_NEW_TOKENS)
    answer_s = time.perf_counter() - t0
    del tok.decode
    if decoded[-1] != stream_ids or answer != strip_generation_markers(streamed):
        fail(f"17.2: turn 1's answer (ids {decoded[-1]}, {answer!r}) is not its stream's "
             f"(ids {stream_ids}, {streamed!r})")
    per_piece = [(s[-1] - s[0]) / (len(s) - 1) if len(s) > 1 else float("nan")
                 for s in (stamps, stamps2)]
    log(f"[chat] 17.2 {CHAT_CONFIG} in-process: model build {build_s:.3f} s; turn 1: first "
        f"piece after {stamps[0]:.4f} s, then {per_piece[0]:.4f} s a piece over "
        f"{len(pieces) - 1} more ({steps} decode steps); turn 2: {stamps2[0]:.4f} s, then "
        f"{per_piece[1]:.4f} s a piece over {len(pieces2) - 1} more; turn 1 through "
        f"Chat.answer {answer_s:.4f} s, the same ids and text; peak memory {peak_gb:.2f} GB; "
        f"{card}")
    log(f"[chat] 17.2 launches of turn 1 {json.dumps(launches)}; turn 1's ids {stream_ids} "
        f"(answer and stream); answers {json.dumps([streamed, chat.conv.messages[3][1]])}")
    del chat, other
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_scripts(torch, card, d_in: int, d_out: int):
    """17: the twins of the JAX package's two scripts. 17.1 runs
    ``scripts/demo_chat_torch.py`` on the shipped certify YAML unchanged
    (its checkpoint variables where nothing exists: seeded weights at full
    width) over a written 448-pixel JPEG with two questions on its input,
    once answering and once streaming; each exits 0 with two ``bot>``
    lines, and turn 1's streamed text is the answer's. Beside them runs
    17.3's ``scripts/verify_attack_torch.py --synthetic``: exit 0, ``ok``,
    the grid of ``vit_tiny`` and ``rn_tiny``. Then 17.2 (``phase_chat``) in
    this process, then 17.3's full mode at ``--images 1`` on the shipped
    attack YAML over phase 14.3's written set and no CLIP checkpoint: exit 1,
    ``undischarged``, 0 checked, 20 skipped, 0 failed, 20 rows. Returns the
    launches of 17.2's chat turn."""
    import tempfile
    from pathlib import Path

    import numpy as np
    from PIL import Image

    from certifiedgpt_tpu_torch.common.config import Config
    from certifiedgpt_tpu_torch.data.text import strip_generation_markers

    demo = load_script(os.path.join(REPO_DIR, DEMO_SCRIPT))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp:
        root = Path(tmp)
        env, _ = launch_files(root, ATTACK_IMAGES, d_in, d_out)
        env.update({name: str(root / "absent" / name.lower()) for name in CLIP_ENV},
                   TMPDIR=str(root))
        image_path = root / "chat.jpg"
        Image.fromarray(np.random.RandomState(17).randint(0, 255, (448, 448, 3),
                                                          dtype=np.uint8)).save(image_path)
        questions = "".join(f"{q}\n" for q in CHAT_QUESTIONS)
        demo_argv = [DEMO_SCRIPT, "--image", str(image_path), "--config", CHAT_CONFIG]
        t0 = time.perf_counter()
        started = [start_script(root, "answer", demo_argv, env, questions),
                   start_script(root, "stream", [*demo_argv, "--stream"], env, questions),
                   start_script(root, "synthetic", [ATTACK_RUNBOOK, "--synthetic", "--report",
                                                    str(root / "synthetic.json")], env)]
        done = finish_scripts(root, started)
        together_s = time.perf_counter() - t0
        answers = {label: demo_answers(label, *done[label][:3]) for label in ("answer", "stream")}
        if strip_generation_markers(answers["stream"][0]) != answers["answer"][0]:
            fail(f"17.1: turn 1 streamed {answers['stream'][0]!r}, answered "
                 f"{answers['answer'][0]!r}")
        log(f"[scripts] 17.1 {DEMO_SCRIPT} --config {CHAT_CONFIG}: bot> lines answered "
            f"{json.dumps(answers['answer'])}, streamed {json.dumps(answers['stream'])}; "
            f"commands {done['answer'][3]:.3f} / {done['stream'][3]:.3f} s")
        rc, out, err, _ = done["synthetic"]
        report = read_report(root / "synthetic.json")
        if rc != 0 or not report.get("ok") or report.get("synthetic") is not True \
                or set(report.get("grid", {})) != {"vit_tiny", "rn_tiny"}:
            fail(f"17.3: {ATTACK_RUNBOOK} --synthetic exited {rc}, report {report}:\n"
                 f"{out[-2000:]}\n{err[-4000:]}")
        log(f"[scripts] 17.3 {ATTACK_RUNBOOK} --synthetic: rc 0, grid "
            f"{json.dumps(report['grid'])}, command {done['synthetic'][3]:.3f} s; the three "
            f"commands together {together_s:.3f} s; {card}")

        launches = phase_chat(torch, card, demo, image_path, env)

        out_dir = root / "out_verify"
        full = start_script(root, "full", [ATTACK_RUNBOOK, "--images", "1", "--report",
                                           str(root / "full.json")],
                            dict(env, OUTPUT_DIR=str(out_dir)))
        rc, out, err, seconds = finish_scripts(root, [full])["full"]
        report = read_report(root / "full.json")
        results = out_dir / "attack_results.jsonl"
        rows = read_rows(results) if results.exists() else []
        n_rows = len(ATTACK_BACKBONES) * len(Config(ATTACK_CONFIG).run.get("sigma_grid"))
        if rc != 1 or "verify_attack_torch: undischarged" not in err \
                or [report.get(k) for k in ("checked", "skipped", "failed", "ok")] \
                != [0, 20, 0, False] or (report.get("ancova") or {}).get("status") != "skipped" \
                or len(rows) != n_rows:
            fail(f"17.3: {ATTACK_RUNBOOK} --images 1 exited {rc} with {len(rows)} rows, "
                 f"report {report}:\n{out[-2000:]}\n{err[-4000:]}")
        log(f"[scripts] 17.3 {ATTACK_RUNBOOK} --images 1 on {ATTACK_CONFIG} (no CLIP "
            f"checkpoint): rc 1, undischarged; checked 0, skipped 20, failed 0, ANCOVA "
            f"skipped; {len(rows)} rows; command {seconds:.3f} s; {card}")
    return launches


# ----------------------------------------------------------------------
# phase 18: the f32 paths at full width
# ----------------------------------------------------------------------
F32_SEED = 18
F32_BATCH = EVAL_BATCH  # 8 rows
F32_PROMPT = RUN_CFG["seq_len"]  # 96 tokens into a cache of 96 + 10 slots
F32_STEPS = RUN_CFG["max_new_tokens"]  # 10 greedy decode steps
# a prefill layer of the f32 decoder (weight-only int8 products, no
# activation quant): its seven products and its cache write and attention
# in one launch of the tiled kernel
F32_PREFILL = plus({"int8_weight_matmul": 7 * LLAMA_DEPTH, "attention_kv8": LLAMA_DEPTH},
                   DECODER_FUSED)
# the f32 decoder's prefill logits through the kernels against their plain
# versions: each f32 product and attention is a few f32 ulps off its plain
# version (its sums' order); the int8 KV cache turns such changes into code
# flips, which 32 random layers carry to the logits: a random change of the
# input embeddings as large as the kernels' first one moves them 1.0e-2
# (H100 80GB HBM3, 700 W). The logits must stay within this relative limit
# and within F32_DECODER_LOGIT_FACTOR times that control's change.
F32_DECODER_REL_LIMIT = 5e-2
F32_DECODER_LOGIT_FACTOR = 2.0
# the tiny certify run of 18.2: two images, sigma 0.25 (tiny model: two
# decoder layers of head_dim 16)
TINY_IMAGES = 2
TINY_LAYERS = 2
TINY_RUN = {"agent": "image_text_certify", "seq_len": 48, "max_new_tokens": 4,
            "noise_level": 0.25, "certify_n0": 8, "certify_n": 16, "certify_alpha": 0.05,
            "mc_batch": 8, "max_images": TINY_IMAGES, "seed": 3}


def f32_decoder_run(torch, params, cfg, ids, valid, record=None):
    """``llama_apply`` over the prompt ``ids`` into a fresh int8 cache of
    ``F32_PROMPT + F32_STEPS`` slots, then ``F32_STEPS`` greedy decode
    steps (the last fills the cache's last slot); returns the prefill's
    logits, the tokens, the prefill's and the decode steps' launches and
    their seconds."""
    from certifiedgpt_tpu_torch.models import llama as TLM

    b, s = ids.shape
    dev = ids.device
    cache = TLM.init_kv_cache(cfg, b, s + F32_STEPS, dev)
    x = TLM.embed_tokens(params, ids)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, _, cache = TLM.llama_apply(params, cfg, x, valid,
                                       torch.arange(s, device=dev)[None].expand(b, s), cache, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prefill = read_counts()
    reset_counts()
    tok = logits[:, -1].argmax(-1)
    tokens = [tok]
    for i in range(F32_STEPS):
        step, _, cache = TLM.llama_apply(params, cfg, TLM.embed_tokens(params, tok[:, None]),
                                         valid, torch.full((b, 1), s + i, device=dev), cache,
                                         s + i)
        tok = step[:, -1].argmax(-1)
        tokens.append(tok)
    torch.cuda.synchronize()
    decode = read_counts()
    return logits, torch.stack(tokens, 1), prefill, decode, t1 - t0, time.perf_counter() - t1


def cache_checker(torch):
    """Patches that wrap ``prefill_attention_kv8`` and
    ``decode_attention_kv8`` (the kernels' entries, called as they are) to
    check each call's cache: the written slots bit for bit the plain
    ``quantize_rows`` of the call's k and v, every other slot as it was.
    Returns the patches and the count of values off."""
    from unittest import mock

    from certifiedgpt_tpu_torch.ops import attention as A
    from certifiedgpt_tpu_torch.ops import quantization as Q

    off = {"values": 0, "calls": 0}

    class Checked:
        """The entry ``real`` with its cache checked; its ``launches`` are
        the real counter's."""

        def __init__(self, real):
            self.real = real

        @property
        def launches(self):
            return self.real.launches

        @launches.setter
        def launches(self, n):
            self.real.launches = n

        def __call__(self, q, k, v, cache, offset, mask=None, scale=None):
            before = copy_cache(cache)
            out = self.real(q, k, v, cache, offset, mask, scale)
            at = slice(offset, offset + k.shape[1])
            kq, ks = Q._quantize_rows_plain(k)
            vq, vs = Q._quantize_rows_plain(v)
            for name, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
                before[name][:, at] = new
            off["values"] += cache_bits_unequal(torch, cache, before)
            off["calls"] += 1
            return out

    return [mock.patch.object(A, "prefill_attention_kv8", Checked(A.prefill_attention_kv8)),
            mock.patch.object(A, "decode_attention_kv8", Checked(A.decode_attention_kv8))], off


def phase_f32_decoder(torch, card, device):
    """18.1: the full-width Vicuna-7B decoder at f32 (``LlamaConfig(dtype=
    torch.float32, kv_quant=True)``, 32 layers, int8 weight-only layer
    kernels, seeded) prefills ``F32_PROMPT`` tokens of ``F32_BATCH`` rows
    into a cache of ``F32_PROMPT + F32_STEPS`` slots (row 0 left-padded by
    two), then takes ``F32_STEPS`` greedy decode steps: through the kernels
    (each call's cache checked bit for bit against the plain quantization
    of its k and v) and under ``plain_versions()``. The prefill's logits
    within ``F32_DECODER_REL_LIMIT`` of the plain run's, beside a control:
    the plain run with its input embeddings changed at random by as much as
    the kernels change the first layer's q product, the logits within
    ``F32_DECODER_LOGIT_FACTOR`` times its change. Launches: a prefill
    layer ``F32_PREFILL`` (no ``quant_rows``), a decode step
    ``PER_DECODE_STEP``. Returns the prefill's launches."""
    from certifiedgpt_tpu_torch.models import layers as L
    from certifiedgpt_tpu_torch.models import llama as TLM
    from certifiedgpt_tpu_torch.models.model_zoo import _Init, _llama_params
    from certifiedgpt_tpu_torch.ops import quantization as Q

    t0 = time.perf_counter()
    cfg = TLM.LlamaConfig(dtype=torch.float32, kv_quant=True)
    params = _llama_params(_Init(F32_SEED, device), cfg, True)
    g = torch.Generator(device=device).manual_seed(F32_SEED)
    ids = torch.randint(0, cfg.vocab_size, (F32_BATCH, F32_PROMPT), generator=g, device=device)
    valid = torch.ones((F32_BATCH, F32_PROMPT + F32_STEPS), dtype=torch.long, device=device)
    valid[0, :2] = 0
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    f32_decoder_run(torch, params, cfg, ids, valid)  # warm-up: first calls, device queries
    # the control's size: how far the kernels move the first layer's q product
    lp = L.layer_slice(params["layers"], 0)
    x0 = TLM.embed_tokens(params, ids).reshape(-1, cfg.hidden_size)
    kq0, sc0 = lp["q_proj"]["kernel_q"], lp["q_proj"]["scale"]
    first = rel_err(Q.int8_weight_forward(x0, kq0, sc0),
                    Q._int8_weight_forward_plain(x0, kq0, sc0))
    patches, off = cache_checker(torch)
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        logits, tokens, pre, dec, pre_s, dec_s = f32_decoder_run(torch, params, cfg, ids, valid)
    _, _, _, _, pre_s, dec_s = f32_decoder_run(torch, params, cfg, ids, valid)  # unchecked times
    with contextlib.ExitStack() as stack:
        for patch in plain_versions():
            stack.enter_context(patch)
        plain_logits, plain_tokens, plain_pre, plain_dec, plain_pre_s, plain_dec_s = \
            f32_decoder_run(torch, params, cfg, ids, valid)
        # control: the kernels' first change (layer 0's q product) as a
        # random change of the plain run's input embeddings
        emb = TLM.embed_tokens(params, ids)
        noise = torch.randn(emb.shape, generator=g, device=device)
        shifted = emb + noise * (first * emb.norm() / noise.norm())
        cache = TLM.init_kv_cache(cfg, F32_BATCH, F32_PROMPT + F32_STEPS, device)
        control, _, _ = TLM.llama_apply(
            params, cfg, shifted, valid,
            torch.arange(F32_PROMPT, device=device)[None].expand(F32_BATCH, F32_PROMPT), cache, 0)
    dev_k, dev_c = rel_err(logits, plain_logits), rel_err(control, plain_logits)
    same = int((tokens == plain_tokens).sum())
    log(f"[f32] 18.1 the full-width f32 decoder ({LLAMA_DEPTH} layers, int8 weight-only, int8 "
        f"KV cache; built in {build_s:.1f} s): prefill of {F32_BATCH} x {F32_PROMPT} tokens "
        f"{pre_s:.4f} s through the kernels, {plain_pre_s:.4f} s through their plain versions; "
        f"{F32_STEPS} decode steps {dec_s:.4f} s, plain {plain_dec_s:.4f} s; prefill logits "
        f"{dev_k:.3e} apart (limits {F32_DECODER_REL_LIMIT:g} and {F32_DECODER_LOGIT_FACTOR:g} x "
        f"the control, a random change of the input embeddings as large as the kernels' change "
        f"of layer 0's q product ({first:.3e}): {dev_c:.3e}); greedy tokens equal to the plain "
        f"run's: {same} of {tokens.numel()}; "
        f"cache values off {off['values']} over {off['calls']} calls; launches: prefill "
        f"{json.dumps(pre)}, decode {json.dumps(dec)}; {card}")
    check_counts("f32 decoder prefill", pre, F32_PREFILL, 1)
    check_counts("f32 decoder decode", dec, {}, 1, F32_STEPS)
    if off["values"] or off["calls"] != LLAMA_DEPTH * (1 + F32_STEPS):
        fail(f"f32 decoder: {off['values']} cache values off bit for bit over {off['calls']} "
             "calls")
    if not (bool(torch.isfinite(logits).all()) and dev_k < F32_DECODER_REL_LIMIT
            and dev_k <= F32_DECODER_LOGIT_FACTOR * dev_c):
        fail(f"f32 decoder: the prefill's logits are {dev_k:.3e} off the plain run's (control "
             f"{dev_c:.3e})")
    del params, logits, plain_logits, control, cache
    gc.collect()
    torch.cuda.empty_cache()
    return pre


def phase_f32_tiny_certify(torch, card):
    """18.2: the certify CLI (``launch.main``) on the tiny model at f32
    (``model_size: tiny`` with int8 weight-only decoder kernels and the
    int8 KV cache, the path the f32 instances serve in the tests' tiny
    configurations) over ``TINY_IMAGES`` written images, once through the
    kernels and once under ``plain_versions()``: the rows (all but their
    seconds) equal the plain run's; each chunk's prefill launches the tiled
    kernel once a layer, each decode step the decode kernel, the f32
    weight-only kernel seven times a layer each, and each of them the
    decoder's fused elementwise kernels (two norms a layer and the final
    one, a rotary and a SiLU x up a layer). Returns the launches."""
    import tempfile
    from pathlib import Path

    from certifiedgpt_tpu_torch.agents import certify as CA
    from certifiedgpt_tpu_torch.common.config import Config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tiny_") as tmp:
        root = Path(tmp)
        write_vqa_set(root, TINY_IMAGES)
        runs = {}
        for mode in ("kernels", "plain"):
            out = root / f"out_{mode}"
            cfg = {"model": {"arch": "minigpt4", "model_size": "tiny", "quantize_llama": True,
                             "kv_quant": True},
                   "datasets": {"evalvqav2": {
                       "vis_processor": {"val": {"name": "blip2_image_val", "image_size": 28}},
                       "build_info": {"images": {"storage": str(root / "images")},
                                      "questions": {"val": [str(root / "questions.json")]},
                                      "annotations": {"val": [str(root / "annotations.json")]}},
                   }},
                   "run": dict(TINY_RUN, output_dir=str(out))}
            path = root / f"tiny_{mode}.yaml"
            path.write_text(json.dumps(cfg))
            with contextlib.ExitStack() as stack:
                if mode == "plain":
                    for patch in plain_versions():
                        stack.enter_context(patch)
                res = run_launch(torch, ["certify", "--config-path", str(path)], {}, out)
            runs[mode] = (res, read_rows(out / "certify_results.jsonl"))
        knobs = CA.SmoothingKnobs.from_run(Config(str(root / "tiny_kernels.yaml")).run)
    (res, rows), (plain_res, plain_rows) = runs["kernels"], runs["plain"]
    strip = [{k: v for k, v in r.items() if k != "seconds"} for r in rows]
    plain_strip = [{k: v for k, v in r.items() if k != "seconds"} for r in plain_rows]
    chunks = sum(dispatched_chunks(r, knobs.n0, knobs.n, knobs.mc_batch, knobs.dispatch_window)
                 for r in rows)
    steps = res["decode_steps"]
    forwards = chunks + steps
    want = {"int8_weight_matmul": 7 * TINY_LAYERS * forwards,
            "attention_kv8": TINY_LAYERS * chunks, "attention_kv8_decode": TINY_LAYERS * steps,
            "add_rms_norm": (2 * TINY_LAYERS + 1) * forwards, "rotary": TINY_LAYERS * forwards,
            "silu_mul": TINY_LAYERS * forwards}
    got = {name: n for name, n in res["launches"].items() if n}
    log(f"[f32] 18.2 the tiny f32 model through the certify CLI: rows {json.dumps(strip)}; "
        f"equal to the plain run's: {strip == plain_strip}; CLI wall {res['wall']:.3f} s "
        f"(plain {plain_res['wall']:.3f} s); {chunks} chunks, {steps} decode steps; launches "
        f"{json.dumps(got)}; {card}")
    check_certify_rows("tiny f32 certify", rows, "certify", TINY_IMAGES,
                       knobs.n0 + knobs.n, knobs.sigma)
    if strip != plain_strip:
        fail(f"tiny f32 certify: rows {strip} differ from the plain run's {plain_strip}")
    if got != want:
        fail(f"tiny f32 certify: launches {got}, expected {want}")
    return res["launches"]


def main() -> int:
    if sys.argv[1:2] == ["--phase15-worker"]:  # one rank of phase 15.1's run
        return phase15_worker(sys.argv[2])
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    try:
        import certifiedgpt_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"certifiedgpt_tpu_torch is not importable ({exc}); run from the repository root")

    card = phase_device(torch)
    device = torch.device("cuda", 0)
    resources = phase_build()
    with torch.no_grad():
        records = phase_kernels(torch, device)
        for name, kernels in resources.items():
            records[name]["ptxas"] = kernels
        if sys.argv[1:] == ["--kernels"]:  # phases 1-3 only, for work on a kernel
            print(json.dumps({"kernel_phase": records}), flush=True)
            return 0
        model, image, main_launches, summary = phase_main_path(torch, device, card)
        flash_launches = phase_forms(torch, model, image, device)
        entry_launches = phase_entries(torch, device)
        # 9.1 and 9.2 run on phase 4's model, before the launcher phases
        # build their own
        lookahead = phase_lookahead(torch, model, image, card, summary)
        t0 = time.perf_counter()
        summary["graphs"] = phase_graphs(torch, card, model, image)
        log(f"[main] phase 19 (a-d, g) took {time.perf_counter() - t0:.1f} s")
        widths = (model.cfg.qformer.hidden_size, model.cfg.llama.hidden_size)
        del model, image
        gc.collect()
        torch.cuda.empty_cache()
        cli_launches, serial_rows = phase_launcher(torch, card, *widths, summary)
        cli_launches["certify continuous"] = phase_continuous(torch, card, *widths, serial_rows)
        cli_launches["eval"] = phase_eval(torch, card, *widths)
    # phase 11 trains: autograd on
    cli_launches.update(phase_train(torch, card, device, *widths))
    with torch.no_grad():
        t0 = time.perf_counter()
        cli_launches["certify from checkpoints"] = phase_checkpoints(torch, card, device, summary)
        t1 = time.perf_counter()
        cli_launches.update(phase_decode(torch, card, device, *widths))
        log(f"[main] phase 12 took {t1 - t0:.1f} s, phase 13 {time.perf_counter() - t1:.1f} s")
    # phase 14: the attack stage (its PGD turns autograd on for itself)
    t0 = time.perf_counter()
    with torch.no_grad():
        batch1 = phase_attack_kernels(torch, device)
    phase_attack_surrogates(torch, card, device)
    cli_launches["attack"] = phase_attack(torch, card, device, *widths)
    log(f"[main] phase 14 took {time.perf_counter() - t0:.1f} s")
    # phase 15: run.distributed (NCCL, world size 1) with the profiler, then
    # the stage split of one chunk's device time
    t0 = time.perf_counter()
    with torch.no_grad():
        cli_launches["certify distributed"] = phase_distributed(torch, card, *widths,
                                                                serial_rows)
        phase_stage_split(torch, card, device)
    log(f"[main] phase 15 took {time.perf_counter() - t0:.1f} s")
    # phase 17: the port's twins of the JAX package's chat demo and attack
    # runbook, as a user runs them
    t0 = time.perf_counter()
    with torch.no_grad():
        cli_launches["chat"] = phase_scripts(torch, card, *widths)
    log(f"[main] phase 17 took {time.perf_counter() - t0:.1f} s")
    # phase 18: the f32 paths at full width (the f32 decoder) and on the tiny
    # model through the certify CLI
    t0 = time.perf_counter()
    with torch.no_grad():
        f32_prefill = phase_f32_decoder(torch, card, device)
        cli_launches["tiny f32 certify"] = phase_f32_tiny_certify(torch, card)
    log(f"[main] phase 18 took {time.perf_counter() - t0:.1f} s")
    for name, rec in batch1.items():
        records[name]["attack_batch1"] = {k: rec[k] for k in (
            "ms", "ms_cls", "plain_ms", "bound_ms", "bound_by", "max_abs_err") if k in rec}
    summary["lookahead"] = lookahead
    log(f"[main] summary {json.dumps(summary)}")
    by_path = {"certify flash_cls": main_launches, "certify flash_custom": flash_launches,
               "eval": cli_launches["eval"], "f32 decoder prefill": f32_prefill,
               "train step": cli_launches["train 11.1"]}
    kernels = []
    for name, source, replaces, path in KERNELS:
        rec = records[name]
        n = by_path[path][name] if path in by_path else entry_launches[name]
        lib_ms = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.3f} ms"
        log(f"[kernel] {name}: {rec['ms']:.3f} ms, bound {rec['bound_ms']:.3f} ms "
            f"({rec['bound_by']}), plain {rec['plain_ms']:.3f} ms, library {lib_ms}; "
            f"{n} launches on its path ({path}); through the launcher "
            f"{json.dumps({m: c.get(name) for m, c in cli_launches.items()})}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "cli_launches": {m: c.get(name) for m, c in cli_launches.items()},
                        **rec})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
