"""The port's metrics catalog as tier-1 pins it.

``TABLE`` is ``cometbft_tpu_torch.tools.metrics_catalog``'s markdown
output, one row a family.  tests/test_torch_observability_drift.py
holds the generator to it and it to the JAX package's generator
(tools/metrics_catalog.py) row for row, apart from ``LEFT_OUT``: the
reference's families the port does not register, each with its reason
(ROADMAP.md lists them under "Deliberately not ported").
chip_smoke.py's phase 23 holds the generator to it on the card.  After
a change to a family, paste in the output of
``python -m cometbft_tpu_torch.tools.metrics_catalog``.
"""

LEFT_OUT = {
    "cometbft_breaker_failures_total":
        "the circuit breaker is not ported: a kernel that fails raises, "
        "there is no CPU path to trip over to",
    "cometbft_breaker_state":
        "the circuit breaker is not ported (as above)",
    "cometbft_breaker_transitions_total":
        "the circuit breaker is not ported (as above)",
    "cometbft_crypto_verify_tile_rejects":
        "it counts the tiles of the JAX package's CPU pipelined verify "
        "path (crypto/pipeline.py:180), which the port does not have",
}

TABLE = """\
| Name | Type | Labels | Help |
|------|------|--------|------|
| `cometbft_blocksync_block_size_bytes` | gauge | — | Size of the latest block. |
| `cometbft_blocksync_latest_block_height` | gauge | — | The latest block height. |
| `cometbft_blocksync_num_txs` | gauge | — | Number of transactions in the latest block. |
| `cometbft_blocksync_syncing` | gauge | — | Whether or not a node is block syncing. 1 if yes, 0 if no. |
| `cometbft_blocksync_total_txs` | counter | — | Total number of transactions fast-synced. |
| `cometbft_consensus_block_gossip_parts_received` | counter | `matches_current` | Number of block parts received by the node, separated by whether the part was relevant to the block the node is trying to gather or not. |
| `cometbft_consensus_block_interval_seconds` | histogram | — | Time between this and the last block. |
| `cometbft_consensus_block_parts` | counter | `peer_id` | Number of block parts transmitted by each peer. |
| `cometbft_consensus_block_size_bytes` | gauge | — | Size of the block. |
| `cometbft_consensus_byzantine_validators` | gauge | — | Number of validators who tried to double sign. |
| `cometbft_consensus_byzantine_validators_power` | gauge | — | Total power of the byzantine validators. |
| `cometbft_consensus_chain_size_bytes` | counter | — | Size of the chain in bytes. |
| `cometbft_consensus_commit_verify_seconds` | histogram | `kind` | Commit verification latency in seconds, by verification kind (aggregate = O(1) BLS pairing path; batch/grouped/single = per-signature paths). |
| `cometbft_consensus_compact_block_mismatches` | counter | — | Compact proposals whose reconstructed part set did not match the advertised part-set header. |
| `cometbft_consensus_compact_block_misses` | counter | — | Compact proposals with at least one tx hash the local mempool could not resolve (fell back to full parts). |
| `cometbft_consensus_compact_blocks_reconstructed` | counter | — | Compact proposals fully rebuilt from the local mempool — no full block parts needed. |
| `cometbft_consensus_compact_blocks_sent` | counter | — | Compact proposals (skeleton + tx hashes) sent to negotiated peers instead of full parts. |
| `cometbft_consensus_duplicate_block_part` | counter | — | Number of times we received a duplicate block part |
| `cometbft_consensus_duplicate_vote` | counter | — | Number of times we received a duplicate vote |
| `cometbft_consensus_full_prevote_delay` | gauge | `proposer_address` | Interval in seconds between the proposal timestamp and the timestamp of the latest prevote in a round where all validators voted. |
| `cometbft_consensus_full_prevote_delay_seconds` | histogram | — | Histogram of the interval in seconds between the proposal timestamp and the latest prevote in rounds where all validators voted. |
| `cometbft_consensus_height` | gauge | — | Height of the chain. |
| `cometbft_consensus_late_votes` | counter | `vote_type` | Number of votes received corresponding to earlier heights/rounds than the node is in. |
| `cometbft_consensus_latest_block_height` | gauge | — | The latest block height. |
| `cometbft_consensus_missing_validators` | gauge | — | Number of validators who did not sign. |
| `cometbft_consensus_missing_validators_power` | gauge | — | Total power of the missing validators. |
| `cometbft_consensus_num_txs` | gauge | — | Number of transactions. |
| `cometbft_consensus_pipeline_apply_seconds` | histogram | — | Duration of the pipelined background execute/commit (FinalizeBlock through mempool update) per height. |
| `cometbft_consensus_pipeline_barrier_wait_seconds` | histogram | — | Time the consensus routine waited on the pipeline barrier before a step that needs the applied state. |
| `cometbft_consensus_proposal_create_count` | counter | — | Total number of proposals created since process start. |
| `cometbft_consensus_proposal_receive_count` | counter | `status` | Total number of proposals received since process start, annotated by app verdict. |
| `cometbft_consensus_proposal_timestamp_difference` | histogram | `is_timely` | Difference in seconds between local receive time and the proposal message timestamp. |
| `cometbft_consensus_quorum_prevote_delay` | gauge | `proposer_address` | Interval in seconds between the proposal timestamp and the timestamp of the earliest prevote that achieved a quorum. |
| `cometbft_consensus_quorum_prevote_delay_seconds` | histogram | — | Histogram of the interval in seconds between the proposal timestamp and the earliest quorum-achieving prevote. |
| `cometbft_consensus_round_duration_seconds` | histogram | — | Histogram of round duration. |
| `cometbft_consensus_round_voting_power_percent` | gauge | `vote_type` | Percentage of the total voting power received with a round, by vote type. |
| `cometbft_consensus_rounds` | gauge | — | Number of rounds. |
| `cometbft_consensus_rounds_per_height` | histogram | — | Histogram of the round number blocks commit in (0 = first round). |
| `cometbft_consensus_step_duration_seconds` | histogram | `step` | Histogram of durations for each step in the consensus protocol. |
| `cometbft_consensus_total_txs` | counter | — | Total number of transactions. |
| `cometbft_consensus_validator_last_signed_height` | gauge | — | Last height signed by this validator if the node is a validator. |
| `cometbft_consensus_validators` | gauge | — | Number of validators. |
| `cometbft_consensus_validators_power` | gauge | — | Total power of all validators. |
| `cometbft_consensus_vote_batches_sent` | counter | — | Coalesced vote messages sent on the vote channel (votebatch/1 links). |
| `cometbft_consensus_vote_extension_receive_count` | counter | `status` | Number of vote extensions received, annotated by application verdict. |
| `cometbft_crypto_agg_pubkey_cache_evictions` | counter | — | Aggregate-pubkey cache LRU evictions. |
| `cometbft_crypto_agg_pubkey_cache_hits` | counter | — | Aggregate-pubkey cache hits (G1 point-sum skipped). |
| `cometbft_crypto_agg_pubkey_cache_misses` | counter | — | Aggregate-pubkey cache misses (G1 point-sum performed). |
| `cometbft_crypto_batch_verify_seconds` | histogram | `backend`, `pad_bucket` | Batch signature verification latency in seconds, by dispatch backend and kernel pad bucket. |
| `cometbft_crypto_kernel_dispatch_seconds` | histogram | `phase`, `kernel`, `pad_bucket`, `warm` | ed25519 kernel dispatch phases (host_prep / kernel_execute) in seconds, by kernel, pad bucket and warm-shape flag. |
| `cometbft_crypto_pad_bucket_refinements` | counter | — | Pad buckets inserted by the measured host_prep/kernel_execute steering (small batches were padding into oversized buckets). |
| `cometbft_crypto_verify_executor_depth` | gauge | `worker` | Tasks queued or running on a verification worker, by worker. |
| `cometbft_crypto_verify_overlap_ratio` | histogram | — | Per-pipeline-run overlap ratio: summed phase wall time divided by pipeline wall time (1.0 = serial, higher = phases genuinely overlapped). |
| `cometbft_crypto_verify_queue_wait_seconds` | histogram | `worker` | Time a task submitted to a verification worker waited in its queue before starting, by worker. |
| `cometbft_light_signature_cache_evictions` | counter | — | Entries evicted by the signature-cache LRU cap. |
| `cometbft_light_signature_cache_hits` | counter | — | Signature-cache hits across commit verifications. |
| `cometbft_light_signature_cache_misses` | counter | — | Signature-cache misses. |
| `cometbft_lightserve_cache_bytes` | gauge | — | RPC response cache resident size in (approximate serialized) bytes. |
| `cometbft_lightserve_cache_entries` | gauge | — | RPC response cache resident entry count. |
| `cometbft_lightserve_cache_entry_bytes` | histogram | — | Serialized size distribution of cached RPC responses. |
| `cometbft_lightserve_cache_evictions_total` | counter | — | RPC response cache entries evicted to stay under rpc.cache_max_bytes. |
| `cometbft_lightserve_cache_hits_total` | counter | — | RPC response cache hits (immutable height-keyed responses served from memory). |
| `cometbft_lightserve_cache_misses_total` | counter | — | RPC response cache misses (response built from the stores; cacheable ones are inserted). |
| `cometbft_mempool_already_received_txs` | counter | — | Number of duplicate transaction receptions (cache hits). |
| `cometbft_mempool_checktx_duration_seconds` | histogram | — | Histogram of CheckTx app round-trip latency in seconds. |
| `cometbft_mempool_checktx_revalidations` | counter | — | CheckTx calls re-issued because a commit cycle raced the in-flight validation (the FinalizeBlock-to-recheck admission gap). |
| `cometbft_mempool_duplicate_delivery_ratio` | gauge | — | gossip_txs_duplicate / gossip_txs_received, cumulative — the redundancy of the tx gossip plane. |
| `cometbft_mempool_evicted_txs` | counter | — | Number of evicted transactions. |
| `cometbft_mempool_failed_txs` | counter | — | Number of failed transactions. |
| `cometbft_mempool_gossip_txs_duplicate` | counter | — | Peer-delivered transactions the dedup cache had already seen. |
| `cometbft_mempool_gossip_txs_received` | counter | — | Transactions delivered by peer gossip, duplicates included. |
| `cometbft_mempool_lane_bytes` | gauge | `lane` | Bytes in a lane. |
| `cometbft_mempool_lane_size` | gauge | `lane` | Number of txs in a lane. |
| `cometbft_mempool_recheck_duration_seconds` | gauge | — | Duration of the last recheck pass. |
| `cometbft_mempool_recheck_pass_duration_seconds` | histogram | — | Histogram of full post-commit recheck pass duration in seconds. |
| `cometbft_mempool_recheck_skipped_txs` | counter | — | Pooled transactions the incremental recheck proved untouched by the committed block and skipped. |
| `cometbft_mempool_recheck_times` | counter | — | Number of times transactions were rechecked in the mempool. |
| `cometbft_mempool_recon_pushed_txs` | counter | — | Brand-new local transactions pushed in full to the fast-path peer subset. |
| `cometbft_mempool_recon_salt_rotations` | counter | — | Summary salt rotations forced by a short-id self-collision. |
| `cometbft_mempool_recon_want_expired` | counter | — | In-flight wants dropped with no advertiser left to retry. |
| `cometbft_mempool_recon_want_refetches` | counter | — | In-flight wants re-issued to another advertiser after the want timeout. |
| `cometbft_mempool_recon_wants_received` | counter | — | Short ids peers pulled from this node. |
| `cometbft_mempool_recon_wants_sent` | counter | — | Short ids pulled from peers (TxWant) after a summary diff found them missing. |
| `cometbft_mempool_rejected_txs` | counter | — | Number of rejected transactions (mempool full / too large). |
| `cometbft_mempool_size` | gauge | — | Number of uncommitted transactions in the mempool. |
| `cometbft_mempool_size_bytes` | gauge | — | Total size of the mempool in bytes. |
| `cometbft_mempool_tx_size_bytes` | histogram | — | Histogram of transaction sizes in bytes. |
| `cometbft_node_event_loop_lag_seconds` | histogram | — | Observed oversleep of a fixed-interval sampler on the node event loop: wakeup_actual - wakeup_scheduled. |
| `cometbft_p2p_message_receive_bytes_total` | counter | `chID` | Number of bytes of each message type received. |
| `cometbft_p2p_message_recv_size_bytes` | histogram | `chID` | Histogram of complete message sizes received per channel. |
| `cometbft_p2p_message_send_bytes_total` | counter | `chID` | Number of bytes of each message type sent. |
| `cometbft_p2p_message_send_size_bytes` | histogram | `chID` | Histogram of complete message sizes sent per channel. |
| `cometbft_p2p_message_useful_bytes_total` | counter | `chID` | Received bytes whose payload was novel to this node, credited per channel by the owning reactor. |
| `cometbft_p2p_peer_pending_send_bytes` | gauge | `peer_id` | Pending bytes to be sent to a given peer. |
| `cometbft_p2p_peers` | gauge | — | Number of peers. |
| `cometbft_p2p_queue_stall_seconds` | histogram | `chID` | Histogram of time a send stalled per channel: blocking waits on a full send queue plus rate-limiter sleeps in the send routine. |
| `cometbft_p2p_recv_rate_limiter_delay` | counter | `peer_id` | Seconds spent sleeping in the receive rate limiter. |
| `cometbft_p2p_send_queue_drops` | counter | `chID` | Number of messages dropped by TrySend on a full per-channel send queue. |
| `cometbft_p2p_send_rate_limiter_delay` | counter | `peer_id` | Seconds spent sleeping in the send rate limiter. |
| `cometbft_proxy_method_timing_seconds` | histogram | `method`, `conn` | Per-call ABCI latency in seconds, by method and named app connection. |
| `cometbft_state_application_block_retain_height` | gauge | — | The retain height set by the application. |
| `cometbft_state_block_store_base_height` | gauge | — | The first height the block store retains. |
| `cometbft_state_consensus_param_updates` | counter | — | Number of consensus parameter updates returned by the application since process start. |
| `cometbft_state_pruning_service_block_retain_height` | gauge | — | The retain height set by the pruning service (data companion). |
| `cometbft_state_validator_set_updates` | counter | — | Number of validator set updates returned by the application since process start. |
| `cometbft_statesync_syncing` | gauge | — | Whether or not a node is state syncing. 1 if yes, 0 if no. |
| `cometbft_supervisor_crashes_total` | counter | `supervisor`, `task` | Uncaught exceptions in supervised loops. |
| `cometbft_supervisor_giveups_total` | counter | `supervisor`, `task` | Supervised loops abandoned after exhausting their restart budget. |
| `cometbft_supervisor_live_tasks` | gauge | `supervisor` | Currently supervised loops. |
| `cometbft_supervisor_restarts_total` | counter | `supervisor`, `task` | Restarts of supervised loops after a crash. |"""

