"""Cloud orchestration: shard fan-out over independent single-GPU Batch tasks.

Port of ``cuking_tpu/cloud``, retargeted from TPU VMs to H100 VMs.  The
reference's L5 layer (SURVEY.md §1): cloud_batch_submit.py renders a GCP
Cloud Batch job of k(k+1)/2 share-nothing GPU tasks, one per shard of
``--split_factor k``.  The ring (``cuking_tpu_torch.parallel.ring``) covers a
cohort over the cards of one host; the fan-out covers cohorts larger than
one host, the reference's deployment model.
"""
