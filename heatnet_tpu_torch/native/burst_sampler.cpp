// Multi-stream time-synchronizing burst sampler — C++ rebuild of the
// image_sampler ROS node (the reference's ros_src/image_sampler/src/
// image_sampler.cpp:32-94), ROS-free.
//
// The reference subscribes 6 camera topics (2x IR16 + 4x RGB), synchronizes
// them with message_filters::ApproximateTime, and republishes bursts of
// `burst_img_count` synchronized tuples every `burst_period` seconds.
//
// This implementation provides:
//   * Synchronizer: N input streams of (stamp_ns, frame_id); emits a
//     synchronized tuple when one frame per stream falls within `slop_ns`
//     (pivot-based greedy matching, the practical core of ApproximateTime).
//   * BurstSampler on top: gates emission so that every `burst_period_ns`
//     at most `burst_img_count` consecutive synchronized tuples pass
//     through (the 5-image burst each second of the reference).
//
// C ABI for ctypes. Thread-unsafe by design (callers own the pump thread,
// as the ROS spinner did).

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <deque>
#include <vector>

namespace {

struct Frame {
    int64_t stamp;
    int64_t id;
};

struct Synchronizer {
    int num_streams;
    int64_t slop_ns;
    std::vector<std::deque<Frame>> queues;
    size_t max_queue;
};

struct BurstSampler {
    Synchronizer sync;
    int64_t burst_period_ns;
    int burst_img_count;
    int64_t burst_start = -1;  // stamp of the first tuple of current burst
    int emitted_in_burst = 0;
};

bool try_match(Synchronizer& s, int64_t* out_stamps, int64_t* out_ids) {
    while (true) {
        for (auto& q : s.queues) {
            if (q.empty()) return false;
        }
        // pivot = latest head stamp; align every stream to its frame
        // closest to the pivot (dropping older ones)
        int64_t pivot = s.queues[0].front().stamp;
        for (auto& q : s.queues) {
            if (q.front().stamp > pivot) pivot = q.front().stamp;
        }
        bool ok = true;
        for (int i = 0; i < s.num_streams; ++i) {
            auto& q = s.queues[i];
            // advance while the next frame is closer to the pivot
            while (q.size() >= 2 &&
                   llabs(q[1].stamp - pivot) <= llabs(q[0].stamp - pivot)) {
                q.pop_front();
            }
            if (llabs(q.front().stamp - pivot) > s.slop_ns) ok = false;
        }
        if (ok) {
            for (int i = 0; i < s.num_streams; ++i) {
                out_stamps[i] = s.queues[i].front().stamp;
                out_ids[i] = s.queues[i].front().id;
                s.queues[i].pop_front();
            }
            return true;
        }
        // no match: drop the single oldest head and retry
        int oldest = 0;
        for (int i = 1; i < s.num_streams; ++i) {
            if (s.queues[i].front().stamp < s.queues[oldest].front().stamp)
                oldest = i;
        }
        s.queues[oldest].pop_front();
        if (s.queues[oldest].empty()) return false;
    }
}

}  // namespace

extern "C" {

void* sync_create(int num_streams, int64_t slop_ns, int max_queue) {
    auto* s = new Synchronizer();
    s->num_streams = num_streams;
    s->slop_ns = slop_ns;
    s->queues.resize(num_streams);
    s->max_queue = static_cast<size_t>(max_queue);
    return s;
}

void sync_destroy(void* h) { delete static_cast<Synchronizer*>(h); }

void sync_push(void* h, int stream, int64_t stamp_ns, int64_t frame_id) {
    auto* s = static_cast<Synchronizer*>(h);
    auto& q = s->queues[stream];
    q.push_back({stamp_ns, frame_id});
    if (q.size() > s->max_queue) q.pop_front();
}

// Returns 1 and fills out_stamps/out_ids (num_streams each) when a
// synchronized tuple is available, else 0.
int sync_poll(void* h, int64_t* out_stamps, int64_t* out_ids) {
    auto* s = static_cast<Synchronizer*>(h);
    return try_match(*s, out_stamps, out_ids) ? 1 : 0;
}

void* burst_create(int num_streams, int64_t slop_ns, int max_queue,
                   double burst_period_s, int burst_img_count) {
    auto* b = new BurstSampler();
    b->sync.num_streams = num_streams;
    b->sync.slop_ns = slop_ns;
    b->sync.queues.resize(num_streams);
    b->sync.max_queue = static_cast<size_t>(max_queue);
    b->burst_period_ns = static_cast<int64_t>(burst_period_s * 1e9);
    b->burst_img_count = burst_img_count;
    return b;
}

void burst_destroy(void* h) { delete static_cast<BurstSampler*>(h); }

void burst_push(void* h, int stream, int64_t stamp_ns, int64_t frame_id) {
    auto* b = static_cast<BurstSampler*>(h);
    auto& q = b->sync.queues[stream];
    q.push_back({stamp_ns, frame_id});
    if (q.size() > b->sync.max_queue) q.pop_front();
}

// Polls the synchronizer and applies burst gating: emits the first
// `burst_img_count` tuples of each period, drops the rest until the next
// period starts (image_sampler.cpp:48-66 semantics).
int burst_poll(void* h, int64_t* out_stamps, int64_t* out_ids) {
    auto* b = static_cast<BurstSampler*>(h);
    int64_t stamps_buf[64];
    int64_t ids_buf[64];
    while (try_match(b->sync, stamps_buf, ids_buf)) {
        const int64_t t = stamps_buf[0];
        if (b->burst_start < 0 || t - b->burst_start >= b->burst_period_ns) {
            b->burst_start = t;
            b->emitted_in_burst = 0;
        }
        if (b->emitted_in_burst < b->burst_img_count) {
            ++b->emitted_in_burst;
            for (int i = 0; i < b->sync.num_streams; ++i) {
                out_stamps[i] = stamps_buf[i];
                out_ids[i] = ids_buf[i];
            }
            return 1;
        }
        // inside the quiet part of the period: tuple is discarded
    }
    return 0;
}

}  // extern "C"
