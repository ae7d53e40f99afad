// Minimal in-process pub/sub message bus (C ABI).
//
// Native equivalent of the reference's msg_filter scaffolding
// (ros_src/learn_msg_filter/src/firstNode.cpp:1-38 publishes a stamped
// string to "rgb_0" at 30 Hz with queue size 5; secondNode subscribes).
// ROS is replaced by a thread-safe topic bus with bounded per-subscriber
// queues (drop-oldest, matching ros::Publisher queue semantics); messages
// are (stamp_ns, byte payload). Feeds the Synchronizer/BurstSampler
// (burst_sampler.cpp) in the ingest pipeline tests.

#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Message {
  int64_t stamp_ns;
  std::vector<uint8_t> payload;
};

struct Subscriber {
  std::string topic;
  size_t queue_size;
  std::deque<Message> queue;
};

struct Bus {
  std::mutex mu;
  std::vector<Subscriber> subs;
};

}  // namespace

extern "C" {

void* bus_create() { return new Bus(); }

void bus_destroy(void* h) { delete static_cast<Bus*>(h); }

// Returns the subscriber id.
int bus_subscribe(void* h, const char* topic, int queue_size) {
  Bus* bus = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lock(bus->mu);
  Subscriber sub;
  sub.topic = topic;
  sub.queue_size = queue_size > 0 ? static_cast<size_t>(queue_size) : 5;
  bus->subs.push_back(std::move(sub));
  return static_cast<int>(bus->subs.size()) - 1;
}

// Fan the message out to every subscriber of the topic (drop-oldest).
void bus_publish(void* h, const char* topic, int64_t stamp_ns,
                 const uint8_t* data, int len) {
  Bus* bus = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lock(bus->mu);
  for (auto& sub : bus->subs) {
    if (sub.topic != topic) continue;
    if (sub.queue.size() >= sub.queue_size) sub.queue.pop_front();
    Message msg;
    msg.stamp_ns = stamp_ns;
    msg.payload.assign(data, data + len);
    sub.queue.push_back(std::move(msg));
  }
}

// Pop the oldest queued message for a subscriber into out_buf.
// Returns payload length, -1 if the queue is empty, -2 if the buffer is
// too small (message stays queued).
int bus_poll(void* h, int sub_id, int64_t* out_stamp_ns, uint8_t* out_buf,
             int buf_len) {
  Bus* bus = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lock(bus->mu);
  if (sub_id < 0 || sub_id >= static_cast<int>(bus->subs.size())) return -1;
  Subscriber& sub = bus->subs[sub_id];
  if (sub.queue.empty()) return -1;
  Message& msg = sub.queue.front();
  int len = static_cast<int>(msg.payload.size());
  if (len > buf_len) return -2;
  *out_stamp_ns = msg.stamp_ns;
  std::memcpy(out_buf, msg.payload.data(), len);
  sub.queue.pop_front();
  return len;
}

// Number of queued messages for a subscriber.
int bus_pending(void* h, int sub_id) {
  Bus* bus = static_cast<Bus*>(h);
  std::lock_guard<std::mutex> lock(bus->mu);
  if (sub_id < 0 || sub_id >= static_cast<int>(bus->subs.size())) return 0;
  return static_cast<int>(bus->subs[sub_id].queue.size());
}

}  // extern "C"
