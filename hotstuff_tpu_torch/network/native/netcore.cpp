// Port copy of hotstuff_tpu/network/native/netcore.cpp, with the same C ABI
// and the same semantics; built by hotstuff_tpu_torch/utils/kernel_build.py
// (build_native) into hotstuff_tpu_torch/_build/, never beside this file.
//
// Native DCN transport: epoll event loop + length-delimited framing +
// reliable-delivery bookkeeping, exposed over a C ABI for ctypes.
//
// Why: the protocol plane's measured floor is Python asyncio's event
// machinery (~15k events/s/core — docs/latency_profile.md). This moves
// the per-event hot path (socket IO, frame reassembly, ACK pairing,
// reconnect/replay) into one C++ epoll thread; Python sees BATCHES of
// events through a packed buffer + eventfd, so its per-frame cost drops
// to a dict lookup and a queue put.
//
// Semantics mirror the asyncio implementation (and the reference's
// network crate, network/src/{receiver,simple_sender,reliable_sender}.rs):
//   - frames: 4-byte big-endian length prefix (LengthDelimitedCodec)
//   - simple sends: best-effort, connection dies on error, next send
//     reconnects; replies read and discarded
//   - reliable sends: per-message id resolved by the peer's ACK bytes
//     (FIFO pairing, cancelled ids skipped), exponential backoff
//     200ms..2x..60s, un-ACKed frames replayed across reconnects
//   - receivers: inbound frames are events; replies (ACKs) are written
//     back on the same connection by command
//
// Threading: ONE loop thread per context. Python talks to it through a
// mutex-guarded command queue (woken by an eventfd) and reads results
// from a mutex-guarded event buffer (signalled by a second eventfd that
// asyncio watches with add_reader). All fds are nonblocking.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <stdlib.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <sys/uio.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr uint32_t MAX_FRAME = 64u * 1024u * 1024u;
constexpr size_t SIMPLE_QUEUE_CAP = 1000;   // frames; matches Python sender
// Per-wake read cap for inbound connections: without it one flooding
// peer's handle_inbound drains its entire kernel buffer in a single
// epoll round, starving other connections and letting a flood blow past
// the listener-pause back-pressure before the pause command is serviced.
// Level-triggered epoll re-fires for the remainder.
// Sized above the dataplane's bulk batch frames (~387 KB): a budget
// below one frame guarantees TWO epoll wakes per frame plus a partial-
// frame memmove on every erase, which is where the native plane lost to
// asyncio on large frames (ROADMAP 3a).
constexpr size_t READ_BATCH_CAP = 512 * 1024;
constexpr size_t READ_CHUNK = 64 * 1024;
constexpr int RETRY_DELAY_MS = 200;
constexpr int RETRY_CAP_MS = 60000;

uint64_t now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000 + uint64_t(ts.tv_nsec) / 1000000;
}

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + uint64_t(ts.tv_nsec);
}

void frame_append(std::string& out, const uint8_t* data, uint32_t len) {
  char hdr[4] = {char(len >> 24), char(len >> 16), char(len >> 8), char(len)};
  out.append(hdr, 4);
  out.append(reinterpret_cast<const char*>(data), len);
}

// Event types surfaced to Python (see hs_net_drain record layout).
enum : uint8_t {
  EV_RECV = 1,    // a=listener_id, b=conn_id, payload=frame
  EV_ACKED = 2,   // a=msg_id, payload=ACK bytes
  EV_GONE = 3,    // a=listener_id, b=conn_id (inbound connection closed)
  // a=listener_id, b=vote count, payload=count fixed-layout vote frames
  // (the vote pre-stage): ONE Python wakeup per poll cycle for the whole
  // fan-in, not one per frame.
  EV_VOTE_BATCH = 4,
  // a=listener_id, b=frame count, payload=count records of
  //   [u64 LE conn_id | u32 LE len | len bytes]
  // — the general-ingress form of the vote pre-stage: every frame a
  // listener's connections produced during one poll cycle rides ONE
  // aggregated event, so the Python side pays one wakeup + one queue put
  // per cycle instead of one per frame (the small-frame ingress floor).
  EV_RECV_BATCH = 5,
};

// Fixed wire layout of a consensus Vote (consensus/messages.py):
//   u8 tag=1 | 32B block hash | u64 LE round | 32B author | 64B signature
// The pre-stage decodes round/author straight from these offsets; any
// frame that is not exactly this shape flows through the normal EV_RECV
// path and Python's full decoder.
constexpr size_t VOTE_WIRE_LEN = 137;
constexpr uint8_t VOTE_TAG = 1;
constexpr size_t VOTE_ROUND_OFF = 33;
constexpr size_t VOTE_AUTHOR_OFF = 41;
// Mirrors Core.MAX_ROUND_LOOKAHEAD: votes fabricated for far-future
// rounds are dropped before they can allocate dedupe state.
constexpr uint64_t VOTE_ROUND_LOOKAHEAD = 1000;

struct Event {
  uint8_t type;
  uint64_t a, b;
  std::string payload;
};

enum : uint8_t {
  CMD_SEND_SIMPLE = 1,   // addr, payload
  CMD_SEND_RELIABLE = 2, // addr, msg_id, payload
  CMD_CANCEL = 3,        // msg_id
  CMD_REPLY = 4,         // conn_id, payload
  CMD_ADD_LISTENER = 5,  // listener fd already bound+listening
  CMD_STOP = 6,
  CMD_CLOSE_LISTENER = 7,  // close listener + its inbound connections
  CMD_PAUSE_LISTENER = 8,  // stop reading inbound conns (back-pressure)
  CMD_RESUME_LISTENER = 9,
  CMD_STATS = 10,  // fill a StatsReq on the loop thread (tests/ops)
  CMD_CONSUMED = 11,  // Python dispatched n frames of a listener
  CMD_SET_VOTE_FILTER = 12,  // listener_id, payload = n*32 author keys
  CMD_SET_ROUND = 13,        // listener_id, count = stale-round cutoff
  CMD_BROADCAST = 14,        // host = "ip:port ip:port ...", payload once
  CMD_SET_FAULTS = 15,       // payload = fault spec (hs_net_faults)
};

// Loop-thread state snapshot, serviced as a command so no lock covers the
// hot maps. The requesting thread blocks until the loop fills it.
struct StatsReq {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  uint64_t pending = 0;    // frames queued, not yet written
  uint64_t inflight = 0;   // written, awaiting ACK
  uint64_t cancelled = 0;  // parked cancel markers
  uint64_t out_conns = 0;
  uint64_t in_conns = 0;
  uint64_t votes_batched = 0;  // vote frames delivered via EV_VOTE_BATCH
  uint64_t votes_dropped = 0;  // vote frames dropped by the pre-stage
  // Extended fields (hs_net_stats_ex; the legacy 7-slot hs_net_stats
  // ignores them).
  uint64_t votes_dropped_dup = 0;  // subset of votes_dropped: identical resends
  uint64_t frames_rx = 0;   // inbound frames parsed (incl. pre-staged votes)
  uint64_t bytes_rx = 0;    // inbound bytes read off sockets
  uint64_t frames_tx = 0;   // outbound frames handed to the kernel
  uint64_t bytes_tx = 0;    // outbound bytes accepted by the kernel
  uint64_t writev_calls = 0;  // writev syscalls (frames_tx/writev_calls =
                              // the egress coalescing factor)
  uint64_t send_drops = 0;  // best-effort sends dropped at a peer's
                            // SIMPLE_QUEUE_CAP back-pressure bound
  uint64_t faults_dropped = 0;  // frames eaten by the hs_net_faults table
  uint64_t faults_delayed = 0;  // frames held by the hs_net_faults table
  // Poll-loop timing (the C++ side of every trace edge): where the loop
  // thread's wall time goes, and how long commands sit in the queue
  // before the loop services them. Cumulative ns + counts — readers
  // derive means/rates from snapshot deltas (telemetry collector).
  uint64_t loop_polls = 0;          // epoll_wait calls
  uint64_t poll_ns = 0;             // wall ns inside epoll_wait (idle+block)
  uint64_t dispatch_ns = 0;         // wall ns handling events/commands/flushes
  uint64_t cmds_serviced = 0;       // commands drained by run_commands
  uint64_t cmd_service_ns = 0;      // sum of enqueue->service latency
  uint64_t cmd_service_max_ns = 0;  // worst single command latency
  // Batched-ingress account (net.native.ingress.* in the catalog):
  // reads = successful recv() syscalls on inbound conns, frames = frames
  // delivered via EV_RECV_BATCH, batches = EV_RECV_BATCH events emitted.
  // frames/batches is the frames-per-wakeup coalescing factor;
  // frames/reads the parse yield per syscall.
  uint64_t ingress_reads = 0;
  uint64_t ingress_frames = 0;
  uint64_t ingress_batches = 0;
};

struct Command {
  uint8_t type;
  std::string host;
  uint16_t port = 0;
  uint64_t id = 0;  // msg_id / conn_id / listener_id
  int fd = -1;
  bool flag = false;  // ADD_LISTENER: auto_ack
  uint64_t count = 0;   // CONSUMED: frames; ADD_LISTENER: high<<32|low
  void* ptr = nullptr;  // STATS: StatsReq*
  uint64_t enq_ns = 0;  // stamped by push_cmd (cmd-queue service latency)
  std::string payload;
};

// A peer that sends frames but never reads its ACKs would grow the
// reply buffer without bound (a byzantine-facing listener must not leak
// memory on hostile traffic): past this cap the connection is dropped.
constexpr size_t IN_OUTBUF_CAP = 1u << 20;

struct InConn {
  int fd;
  uint64_t id;
  uint64_t listener_id;
  std::string inbuf;
  std::string outbuf;  // replies (ACKs)
  bool auto_ack = false;
  bool dead = false;
  bool paused = false;  // reads suspended; kernel buffer back-pressures peer
};

struct PendingMsg {
  uint64_t msg_id;  // 0 for simple frames
  std::string frame;  // already length-prefixed
};

struct OutConn {
  uint64_t key_hash;
  std::string host;
  uint16_t port;
  bool reliable;
  int fd = -1;
  bool connecting = false;
  std::string inbuf;   // ACK frames (reliable) / discarded replies (simple)
  std::string outbuf;  // bytes in the kernel-bound staging buffer
  // reliable: frames not yet written on the CURRENT socket (replayed);
  // simple: frames waiting for the connection to come up.
  std::deque<PendingMsg> pending;
  // reliable only: written on this socket, awaiting ACK (FIFO).
  std::deque<PendingMsg> inflight;
  int backoff_ms = RETRY_DELAY_MS;
  uint64_t next_retry_ms = 0;  // 0 = connect now
};

struct Listener {
  int fd = -1;
  bool auto_ack = false;
  bool cmd_paused = false;    // explicit hs_net_pause_listener
  bool flood_paused = false;  // outstanding-event budget exceeded
  // EV_RECV events emitted but not yet reported dispatched by Python.
  // The budget must live HERE, not in Python: the sender writes to the
  // kernel synchronously, so a flood is fully read and emitted before
  // the Python loop ever runs — a Python-side pause is always too late.
  uint64_t outstanding = 0;
  uint32_t high = 0;  // 0 = unbounded (no budget)
  uint32_t low = 0;
  bool paused() const { return cmd_paused || flood_paused; }

  // -- vote pre-stage (hs_net_set_vote_filter) --
  // The pre-stage is a FILTER, never a trust root: everything it admits
  // is re-checked (round, authority, signature) by the consensus core;
  // it may only drop frames the core would provably drop cheaply —
  // unknown seats, stale/far-future rounds, and byte-identical resends
  // of a seat's latest vote.
  bool vf_enabled = false;
  std::unordered_map<std::string, uint32_t> vf_seats;  // 32B key -> seat
  uint64_t vf_round = 0;  // stale cutoff, pushed down on round advance
  // round -> seat -> latest admitted vote frame (dedupe by identity);
  // ordered by round so advancing the cutoff GCs with an erase-range.
  std::map<uint64_t, std::unordered_map<uint32_t, std::string>> vf_seen;
  // Admitted votes accumulated during the current poll cycle, flushed as
  // ONE EV_VOTE_BATCH per cycle.
  std::string vote_buf;
  uint64_t vote_count = 0;

  // General inbound frames accumulated during the current poll cycle,
  // flushed as ONE EV_RECV_BATCH per cycle (records carry the conn_id so
  // reply channels survive aggregation).
  std::string ingress_buf;
  uint64_t ingress_count = 0;
};

// A single EV_RECV_BATCH payload is flushed early past this size so the
// Python drain buffer doesn't have to grow toward the per-cycle inbound
// bound (conns x READ_BATCH_CAP); the event stays "one per cycle" in the
// common case and degrades to a handful under extreme bulk.
constexpr size_t INGRESS_FLUSH_CAP = 2u * 1024u * 1024u;

// Test-only per-peer fault injection (hs_net_faults): chaos scenarios
// must also exercise the native egress path (broadcast coalescing, the
// writev pump, the vote fan-in it feeds) under loss and latency. Rules
// apply to BEST-EFFORT frames only (simple sends and broadcasts): the
// reliable path's replay machinery gives injected loss there different
// semantics, and the Python fault plane already covers it.
struct PeerFault {
  uint32_t drop_ppm = 0;   // parts-per-million drop probability
  uint32_t delay_ms = 0;   // fixed hold before the frame enters the queue
  uint64_t rng = 0;        // per-peer xorshift stream (seeded, replayable)
};

struct DelayedFrame {
  std::string host;
  uint16_t port;
  std::string frame;  // already length-prefixed
};

struct AddrKey {
  std::string host;
  uint16_t port;
  bool reliable;
  bool operator==(const AddrKey& o) const {
    return port == o.port && reliable == o.reliable && host == o.host;
  }
};
struct AddrKeyHash {
  size_t operator()(const AddrKey& k) const {
    return std::hash<std::string>()(k.host) ^ (size_t(k.port) << 1) ^
           (k.reliable ? 0x9e3779b9u : 0);
  }
};

class NetCore {
 public:
  NetCore() {
    epfd_ = epoll_create1(EPOLL_CLOEXEC);
    cmd_efd_ = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    out_efd_ = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.u64 = TAG_CMD;
    epoll_ctl(epfd_, EPOLL_CTL_ADD, cmd_efd_, &ev);
    thread_ = std::thread([this] { loop(); });
  }

  // Destroy contract: no other thread may be INSIDE any hs_net_* call
  // (including the synchronous hs_net_stats/hs_net_stats_ex) when
  // destroy begins — ctypes callers must sequence destroy after their
  // last call returns. The narrower race — a push_cmd that took cmd_mu_
  // BEFORE destroy but would have signalled the eventfd after the
  // destructor closed it — is closed structurally: wake() runs while
  // cmd_mu_ is still held (see push_cmd), and the destructor itself
  // acquires cmd_mu_ below, so any in-flight enqueue has fully finished
  // (wake included) before CMD_STOP is even queued, and cmd_efd_ is
  // closed only after thread_.join().
  ~NetCore() {
    {
      std::lock_guard<std::mutex> g(cmd_mu_);
      Command c;
      c.type = CMD_STOP;
      commands_.push_back(std::move(c));
      wake();
    }
    thread_.join();
    for (auto& [id, c] : in_conns_) close(c.fd);
    for (auto& [k, c] : out_conns_) {
      if (c.fd >= 0) close(c.fd);
    }
    for (auto& [id, l] : listeners_) close(l.fd);
    close(epfd_);
    close(cmd_efd_);
    close(out_efd_);
  }

  int out_event_fd() const { return out_efd_; }

  // Called from the Python thread: bind+listen synchronously (errors are
  // immediate), hand the fd to the loop. With auto_ack, the loop thread
  // writes an "Ack" frame back the moment a frame arrives — the sender's
  // back-pressure signal no longer waits for the receiving PROCESS to be
  // scheduled (handlers ACK before processing anyway, so semantics
  // match; reference consensus.rs:144-153, mempool.rs:224-237).
  int64_t listen_on(const char* host, uint16_t port, bool auto_ack,
                    uint32_t high_water, uint32_t low_water) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) return -errno;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      close(fd);
      return -EINVAL;
    }
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) < 0 ||
        ::listen(fd, 1024) < 0) {
      int e = errno;
      close(fd);
      return -e;
    }
    uint64_t id = next_listener_id_++;
    Command c;
    c.type = CMD_ADD_LISTENER;
    c.fd = fd;
    c.id = id;
    c.flag = auto_ack;
    c.count = (uint64_t(high_water) << 32) | uint64_t(low_water);
    if (!push_cmd(std::move(c))) {
      // Loop already shut down: the listener would never be registered.
      close(fd);
      return -ESHUTDOWN;
    }
    return int64_t(id);
  }

  // Returns false once the loop thread has stopped accepting commands
  // (CMD_STOP processed): a command pushed after that would never be
  // serviced, which matters for synchronous requests (CMD_STATS) whose
  // caller blocks on completion.
  //
  // wake() runs UNDER cmd_mu_, not after it: released-then-wake left a
  // window where a thread enqueuing just before destroy could write to a
  // cmd_efd_ the destructor had already closed (or the kernel had
  // reused). With the signal inside the critical section, the destructor
  // — which must take cmd_mu_ to enqueue CMD_STOP — cannot proceed until
  // any in-flight enqueue+wake has fully completed.
  bool push_cmd(Command&& c) {
    c.enq_ns = now_ns();
    std::lock_guard<std::mutex> g(cmd_mu_);
    if (!accepting_) return false;
    commands_.push_back(std::move(c));
    wake();
    return true;
  }

  // Bulk enqueue for the command ring (hs_net_cmds_flush): a whole
  // event-loop iteration's commands take ONE mutex acquisition and ONE
  // eventfd wake instead of one ctypes crossing + lock + wake each.
  // Same cmd_mu_ contract and enq_ns stamping as push_cmd, so the
  // cmd_service_* counters price ring-delivered commands identically.
  bool push_cmds(std::deque<Command>&& cmds) {
    uint64_t t = now_ns();
    for (auto& c : cmds) c.enq_ns = t;
    std::lock_guard<std::mutex> g(cmd_mu_);
    if (!accepting_) return false;
    for (auto& c : cmds) commands_.push_back(std::move(c));
    wake();
    return true;
  }

  // Drain events into a packed buffer:
  //   [u8 type][u64 a][u64 b][u32 len][len bytes] ...
  // Returns bytes written (0 = nothing pending).
  int64_t drain(uint8_t* buf, uint32_t cap) {
    std::lock_guard<std::mutex> g(ev_mu_);
    size_t off = 0;
    while (!events_.empty()) {
      Event& e = events_.front();
      size_t need = 1 + 8 + 8 + 4 + e.payload.size();
      if (need > cap && off == 0) {
        // A single event larger than the caller's buffer: report the
        // required size as a negative count so Python can grow and
        // retry (frames go up to MAX_FRAME).
        return -int64_t(need);
      }
      if (off + need > cap) break;
      buf[off++] = e.type;
      memcpy(buf + off, &e.a, 8);
      off += 8;
      memcpy(buf + off, &e.b, 8);
      off += 8;
      uint32_t len = uint32_t(e.payload.size());
      memcpy(buf + off, &len, 4);
      off += 4;
      memcpy(buf + off, e.payload.data(), len);
      off += len;
      events_.pop_front();
    }
    if (events_.empty()) {
      // All consumed: clear the coalescing flag so the next emit
      // re-signals the eventfd (the caller loops on drain until 0, so
      // partial drains need no re-arm).
      out_signaled_.store(false, std::memory_order_release);
    }
    return int64_t(off);
  }

 private:
  static constexpr uint64_t TAG_CMD = ~0ull;
  // epoll tags: listeners get 1<<62 | idx; inbound conns 1<<61 | id;
  // outbound conns 1<<60 | key-slot.
  static constexpr uint64_t TAG_LISTENER = 1ull << 62;
  static constexpr uint64_t TAG_IN = 1ull << 61;
  static constexpr uint64_t TAG_OUT = 1ull << 60;

  // Both signals are coalesced through an atomic flag: a burst of
  // commands (or events) costs ONE eventfd syscall, not one per item.
  void wake() {
    if (!cmd_signaled_.exchange(true, std::memory_order_acq_rel)) {
      uint64_t one = 1;
      (void)!write(cmd_efd_, &one, 8);
    }
  }

  void signal_out() {
    if (!out_signaled_.exchange(true, std::memory_order_acq_rel)) {
      uint64_t one = 1;
      (void)!write(out_efd_, &one, 8);
    }
  }

  void emit(Event&& e) {
    {
      std::lock_guard<std::mutex> g(ev_mu_);
      events_.push_back(std::move(e));
    }
    signal_out();
  }

  void loop() {
    std::vector<epoll_event> evs(256);
    while (!stop_) {
      int timeout = next_timeout();
      uint64_t t_poll = now_ns();
      int n = epoll_wait(epfd_, evs.data(), int(evs.size()), timeout);
      uint64_t t_wake = now_ns();
      loop_polls_++;
      poll_ns_ += t_wake - t_poll;
      uint64_t now = now_ms();
      for (int i = 0; i < n; i++) {
        uint64_t tag = evs[i].data.u64;
        uint32_t flags = evs[i].events;
        if (tag == TAG_CMD) {
          uint64_t junk;
          while (read(cmd_efd_, &junk, 8) == 8) {
          }
          // Clear BEFORE swapping the queue: a producer enqueueing after
          // the swap sees the flag false and re-signals.
          cmd_signaled_.store(false, std::memory_order_release);
          run_commands();
        } else if (tag & TAG_LISTENER) {
          accept_all(tag & ~TAG_LISTENER);
        } else if (tag & TAG_IN) {
          handle_inbound(tag & ~TAG_IN, flags);
        } else if (tag & TAG_OUT) {
          handle_outbound(tag & ~TAG_OUT, flags);
        }
      }
      flush_vote_batches();
      flush_ingress_batches();
      flush_delayed_frames(now);
      // Reconnect timers: disconnected reliable connections redial on
      // their backoff schedule whether or not traffic is queued (the
      // reference's keep_alive loop does the same).
      for (auto& [key, c] : out_conns_) {
        if (c.fd < 0 && c.reliable && c.next_retry_ms <= now) {
          start_connect(c);
        }
      }
      dispatch_ns_ += now_ns() - t_wake;
    }
    // Stop accepting, then complete any synchronous requests that were
    // enqueued before the flag flipped — without this a caller blocked
    // in hs_net_stats would wait forever once the loop thread exits.
    std::deque<Command> stranded;
    {
      std::lock_guard<std::mutex> g(cmd_mu_);
      accepting_ = false;
      stranded.swap(commands_);
    }
    for (auto& c : stranded) {
      if (c.type == CMD_STATS) {
        auto* s = static_cast<StatsReq*>(c.ptr);
        std::lock_guard<std::mutex> g(s->mu);
        s->done = true;  // zeros: the loop is gone, nothing is live
        s->cv.notify_one();
      } else if (c.type == CMD_ADD_LISTENER && c.fd >= 0) {
        // listen_on bound it; nobody else will close it. Its caller
        // already holds a "valid" listener id, so closing the fd alone
        // would leave Python tracking a phantom listener forever. Emit
        // an EV_GONE with conn_id 0 — the "listener itself is gone"
        // marker (real inbound conn ids start at 1) — so the wrapper
        // drops the id from its table. The event buffer and out_efd_
        // outlive the loop thread (closed only in the destructor), so
        // a caller still draining picks it up.
        close(c.fd);
        emit(Event{EV_GONE, c.id, 0, {}});
      }
    }
  }

  int next_timeout() {
    uint64_t now = now_ms();
    int64_t best = -1;
    for (auto& [key, c] : out_conns_) {
      if (c.fd < 0 && c.reliable) {
        int64_t d = int64_t(c.next_retry_ms) - int64_t(now);
        if (d < 0) d = 0;
        if (best < 0 || d < best) best = d;
      }
    }
    if (!delayed_frames_.empty()) {
      int64_t d = int64_t(delayed_frames_.begin()->first) - int64_t(now);
      if (d < 0) d = 0;
      if (best < 0 || d < best) best = d;
    }
    return int(best);
  }

  void run_commands() {
    std::deque<Command> cmds;
    {
      std::lock_guard<std::mutex> g(cmd_mu_);
      cmds.swap(commands_);
    }
    if (!cmds.empty()) {
      // Queue-service latency: how long each command waited between the
      // caller's push_cmd and this drain — the ctypes boundary's loop-
      // side half (the Python side is accounted by the sampling
      // profiler's ctypes wrappers).
      uint64_t t_service = now_ns();
      for (auto& c : cmds) {
        uint64_t waited = t_service > c.enq_ns ? t_service - c.enq_ns : 0;
        cmd_service_ns_ += waited;
        if (waited > cmd_service_max_ns_) cmd_service_max_ns_ = waited;
      }
      cmds_serviced_ += cmds.size();
    }
    for (auto& c : cmds) {
      switch (c.type) {
        case CMD_STOP:
          stop_ = true;
          break;
        case CMD_ADD_LISTENER: {
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = TAG_LISTENER | c.id;
          Listener& l = listeners_[c.id];
          l.fd = c.fd;
          l.auto_ack = c.flag;
          l.high = uint32_t(c.count >> 32);
          l.low = uint32_t(c.count & 0xffffffffu);
          epoll_ctl(epfd_, EPOLL_CTL_ADD, c.fd, &ev);
          break;
        }
        case CMD_CLOSE_LISTENER: {
          auto it = listeners_.find(c.id);
          if (it != listeners_.end()) {
            epoll_ctl(epfd_, EPOLL_CTL_DEL, it->second.fd, nullptr);
            close(it->second.fd);
            listeners_.erase(it);
          }
          std::vector<uint64_t> doomed;
          for (auto& [cid, conn] : in_conns_) {
            if (conn.listener_id == c.id) doomed.push_back(cid);
          }
          for (uint64_t cid : doomed) {
            auto cit = in_conns_.find(cid);
            if (cit != in_conns_.end()) {
              close(cit->second.fd);
              in_conns_.erase(cit);
            }
          }
          break;
        }
        case CMD_SEND_SIMPLE:
          send_simple(c.host, c.port, c.payload);
          break;
        case CMD_BROADCAST:
          broadcast_simple(c.host, c.payload);
          break;
        case CMD_SET_FAULTS:
          set_faults(c.payload);
          break;
        case CMD_SET_VOTE_FILTER: {
          auto it = listeners_.find(c.id);
          if (it != listeners_.end()) {
            Listener& l = it->second;
            l.vf_seats.clear();
            l.vf_seen.clear();
            for (size_t i = 0; i + 32 <= c.payload.size(); i += 32) {
              l.vf_seats.emplace(c.payload.substr(i, 32), uint32_t(i / 32));
            }
            l.vf_enabled = !l.vf_seats.empty();
          }
          break;
        }
        case CMD_SET_ROUND: {
          auto it = listeners_.find(c.id);
          if (it != listeners_.end()) {
            Listener& l = it->second;
            if (c.count > l.vf_round) {
              l.vf_round = c.count;
              // GC dedupe state for rounds now below the cutoff.
              l.vf_seen.erase(l.vf_seen.begin(),
                              l.vf_seen.lower_bound(c.count));
            }
          }
          break;
        }
        case CMD_SEND_RELIABLE:
          send_reliable(c.host, c.port, c.id, c.payload);
          break;
        case CMD_CANCEL: {
          // Reclaim immediately instead of parking the id: queued frames
          // for a permanently-down peer are only pruned in pump_out,
          // which never runs while disconnected — meanwhile the Python
          // side releases its back-pressure slot on cancellation and
          // keeps queueing, so pending/cancelled_ would grow without
          // bound (one proposal+vote per round per crashed peer). Erase
          // the frame from every pending queue now; only messages
          // already WRITTEN on a live socket (inflight) still need the
          // cancelled_ marker for FIFO ACK pairing. A cancel racing an
          // already-drained ACK matches neither and is dropped outright.
          // msg_ids are unique: stop at the first hit (found in pending
          // implies not inflight and vice versa).
          bool found_pending = false;
          bool still_inflight = false;
          for (auto& [key, oc] : out_conns_) {
            if (!oc.reliable) continue;
            for (auto it = oc.pending.begin(); it != oc.pending.end(); ++it) {
              if (it->msg_id == c.id) {
                oc.pending.erase(it);
                found_pending = true;
                break;
              }
            }
            if (found_pending) break;
            for (auto& m : oc.inflight) {
              if (m.msg_id == c.id) {
                still_inflight = true;
                break;
              }
            }
            if (still_inflight) break;
          }
          if (still_inflight) cancelled_.insert(c.id);
          break;
        }
        case CMD_PAUSE_LISTENER:
        case CMD_RESUME_LISTENER: {
          auto it = listeners_.find(c.id);
          if (it != listeners_.end()) {
            it->second.cmd_paused = (c.type == CMD_PAUSE_LISTENER);
            apply_listener_pause(c.id, it->second);
          }
          break;
        }
        case CMD_CONSUMED: {
          auto it = listeners_.find(c.id);
          if (it != listeners_.end()) {
            Listener& l = it->second;
            l.outstanding -= std::min(l.outstanding, c.count);
            if (l.flood_paused && l.outstanding <= l.low) {
              l.flood_paused = false;
              apply_listener_pause(c.id, l);
            }
          }
          break;
        }
        case CMD_STATS: {
          auto* s = static_cast<StatsReq*>(c.ptr);
          for (auto& [key, oc] : out_conns_) {
            s->pending += oc.pending.size();
            s->inflight += oc.inflight.size();
          }
          s->cancelled = cancelled_.size();
          s->out_conns = out_conns_.size();
          s->in_conns = in_conns_.size();
          s->votes_batched = votes_batched_;
          s->votes_dropped = votes_dropped_;
          s->votes_dropped_dup = votes_dropped_dup_;
          s->frames_rx = frames_rx_;
          s->bytes_rx = bytes_rx_;
          s->frames_tx = frames_tx_;
          s->bytes_tx = bytes_tx_;
          s->writev_calls = writev_calls_;
          s->send_drops = send_drops_;
          s->faults_dropped = faults_dropped_;
          s->faults_delayed = faults_delayed_;
          s->loop_polls = loop_polls_;
          s->poll_ns = poll_ns_;
          s->dispatch_ns = dispatch_ns_;
          s->cmds_serviced = cmds_serviced_;
          s->cmd_service_ns = cmd_service_ns_;
          s->cmd_service_max_ns = cmd_service_max_ns_;
          s->ingress_reads = ingress_reads_;
          s->ingress_frames = ingress_frames_;
          s->ingress_batches = ingress_batches_;
          {
            // notify under the lock: after the unlock the waiter may
            // (spurious wakeup) observe done and destroy the
            // stack-allocated request, leaving notify_one dangling.
            std::lock_guard<std::mutex> g(s->mu);
            s->done = true;
            s->cv.notify_one();
          }
          break;
        }
        case CMD_REPLY: {
          auto it = in_conns_.find(c.id);
          if (it != in_conns_.end() && !it->second.dead) {
            frame_append(it->second.outbuf,
                         reinterpret_cast<const uint8_t*>(c.payload.data()),
                         uint32_t(c.payload.size()));
            flush_inbound(it->second);
          }
          break;
        }
      }
    }
  }

  // ---- inbound ----

  // Sync every inbound connection's epoll interest with the listener's
  // effective pause state. While paused no socket is read, so the kernel
  // buffer fills and TCP flow control reaches the peer — the same bound
  // the asyncio receiver gets from reading one frame per dispatch.
  // Level-triggered epoll re-fires EPOLLIN on resume for buffered bytes.
  void apply_listener_pause(uint64_t listener_id, Listener& l) {
    bool pause = l.paused();
    for (auto& [cid, conn] : in_conns_) {
      if (conn.listener_id != listener_id || conn.paused == pause) continue;
      conn.paused = pause;
      epoll_event ev{};
      ev.events = (pause ? 0u : uint32_t(EPOLLIN)) |
                  (conn.outbuf.empty() ? 0u : uint32_t(EPOLLOUT));
      ev.data.u64 = TAG_IN | cid;
      epoll_ctl(epfd_, EPOLL_CTL_MOD, conn.fd, &ev);
    }
  }

  void accept_all(uint64_t listener_id) {
    auto lit = listeners_.find(listener_id);
    if (lit == listeners_.end()) return;
    int lfd = lit->second.fd;
    while (true) {
      int fd = accept4(lfd, nullptr, nullptr, SOCK_NONBLOCK | SOCK_CLOEXEC);
      if (fd < 0) break;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
      uint64_t id = next_conn_id_++;
      InConn& c = in_conns_[id];
      c.fd = fd;
      c.id = id;
      c.listener_id = listener_id;
      c.auto_ack = lit->second.auto_ack;
      c.paused = lit->second.paused();
      epoll_event ev{};
      ev.events = c.paused ? 0u : uint32_t(EPOLLIN);
      ev.data.u64 = TAG_IN | id;
      epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  void drop_inbound(uint64_t id) {
    auto it = in_conns_.find(id);
    if (it == in_conns_.end()) return;
    emit(Event{EV_GONE, it->second.listener_id, id, {}});
    close(it->second.fd);
    in_conns_.erase(it);
  }

  void handle_inbound(uint64_t id, uint32_t flags) {
    auto it = in_conns_.find(id);
    if (it == in_conns_.end()) return;
    InConn& c = it->second;
    if (flags & (EPOLLERR | EPOLLHUP)) {
      drop_inbound(id);
      return;
    }
    if (flags & EPOLLIN) {
      // Read everything available, REMEMBERING eof/error instead of
      // acting on it: when a one-shot peer's final frame and its FIN
      // coalesce into one epoll wake (routine on loopback), dropping
      // the connection before parsing would silently discard that
      // frame. Parse first, drop after.
      bool conn_gone = false;
      size_t got = 0;
      while (got < READ_BATCH_CAP) {
        // Read straight into inbuf's tail — staging through a stack
        // buffer costs an extra pass over every received byte, which
        // dominates at bulk-frame sizes.
        size_t old = c.inbuf.size();
        c.inbuf.resize(old + READ_CHUNK);
        ssize_t r = read(c.fd, &c.inbuf[old], READ_CHUNK);
        if (r > 0) {
          c.inbuf.resize(old + size_t(r));
          got += size_t(r);
          bytes_rx_ += uint64_t(r);
          ingress_reads_++;
        } else {
          c.inbuf.resize(old);
          if (r == 0 || (errno != EAGAIN && errno != EWOULDBLOCK))
            conn_gone = true;
          break;
        }
      }
      // Reassemble frames, charging each against the listener's
      // outstanding-event budget: past high-water, reads stop until
      // Python reports dispatch progress (CMD_CONSUMED). Frames already
      // buffered in inbuf still parse — the bound is high + one read
      // batch, never the whole flood.
      Listener* l = nullptr;
      auto lit = listeners_.find(c.listener_id);
      if (lit != listeners_.end()) l = &lit->second;
      size_t off = 0;
      while (c.inbuf.size() - off >= 4) {
        const uint8_t* p = reinterpret_cast<const uint8_t*>(c.inbuf.data()) + off;
        uint32_t len = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                       (uint32_t(p[2]) << 8) | uint32_t(p[3]);
        if (len > MAX_FRAME) {
          drop_inbound(id);
          return;
        }
        if (c.inbuf.size() - off - 4 < len) break;
        frames_rx_++;
        bool charge = true;
        if (l != nullptr && l->vf_enabled && len == VOTE_WIRE_LEN &&
            uint8_t(c.inbuf[off + 4]) == VOTE_TAG) {
          charge = prestage_vote(*l, c.inbuf.data() + off + 4);
        } else if (l != nullptr) {
          // Accumulate into the listener's per-cycle batch instead of
          // emitting per frame: the whole cycle's ingress costs Python
          // one wakeup (flush_ingress_batches, same shape as votes).
          char rec[12];
          memcpy(rec, &id, 8);        // u64 LE conn_id (header struct <QI)
          memcpy(rec + 8, &len, 4);   // u32 LE frame length
          l->ingress_buf.append(rec, 12);
          l->ingress_buf.append(c.inbuf.data() + off + 4, len);
          l->ingress_count++;
          ingress_frames_++;
          if (l->ingress_buf.size() >= INGRESS_FLUSH_CAP) {
            flush_ingress(c.listener_id, *l);
          }
        } else {
          emit(Event{EV_RECV, c.listener_id, id,
                     c.inbuf.substr(off + 4, len)});
        }
        if (c.auto_ack) {
          // ACK every frame — including pre-stage drops: the asyncio
          // receiver ACKs before its (Python-side) drop too, so sender
          // back-pressure accounting is transport-independent.
          frame_append(c.outbuf, reinterpret_cast<const uint8_t*>("Ack"), 3);
        }
        off += 4 + len;
        if (charge && l != nullptr && l->high != 0) {
          l->outstanding++;
          if (!l->flood_paused && l->outstanding >= l->high) {
            l->flood_paused = true;
            apply_listener_pause(c.listener_id, *l);
          }
        }
      }
      if (off) c.inbuf.erase(0, off);
      if (conn_gone) {
        drop_inbound(id);  // frames above were parsed first
        return;
      }
      if (!c.outbuf.empty()) {
        flush_inbound(c);
        return;  // flush_inbound may have dropped the connection
      }
    }
    if (flags & EPOLLOUT) flush_inbound(c);
  }

  // Classify one vote frame (VOTE_WIRE_LEN bytes at ``frame``) against
  // the listener's committee table. Admitted votes accumulate in the
  // listener's per-cycle batch buffer; returns true iff the frame was
  // admitted (and should charge the outstanding-event budget). Drops are
  // exactly the core's cheap pre-verification drops: unknown seat, round
  // below the pushed-down cutoff or beyond the lookahead bound, and a
  // byte-identical resend of the seat's latest admitted vote. A DIFFERENT
  // payload for an occupied seat always passes through — spoof/
  // equivocation arbitration (individual verification, re-seat, ejection)
  // stays in the core, where the Signature semantics live.
  bool prestage_vote(Listener& l, const char* frame) {
    uint64_t round;
    memcpy(&round, frame + VOTE_ROUND_OFF, 8);  // wire is little-endian
    auto seat_it = l.vf_seats.find(std::string(frame + VOTE_AUTHOR_OFF, 32));
    if (seat_it == l.vf_seats.end() || round < l.vf_round ||
        round > l.vf_round + VOTE_ROUND_LOOKAHEAD) {
      votes_dropped_++;
      return false;
    }
    auto& seat_map = l.vf_seen[round];
    auto prev = seat_map.find(seat_it->second);
    if (prev != seat_map.end() &&
        prev->second.compare(0, VOTE_WIRE_LEN, frame, VOTE_WIRE_LEN) == 0) {
      votes_dropped_++;  // identical resend of this seat's latest vote
      votes_dropped_dup_++;
      return false;
    }
    seat_map[seat_it->second] = std::string(frame, VOTE_WIRE_LEN);
    l.vote_buf.append(frame, VOTE_WIRE_LEN);
    l.vote_count++;
    votes_batched_++;
    return true;
  }

  // One aggregated event per listener per poll cycle: the whole vote
  // fan-in of the cycle costs Python a single wakeup + decode loop.
  void flush_vote_batches() {
    for (auto& [lid, l] : listeners_) {
      if (l.vote_count == 0) continue;
      emit(Event{EV_VOTE_BATCH, lid, l.vote_count, std::move(l.vote_buf)});
      l.vote_buf.clear();  // moved-from: reset to a known state
      l.vote_count = 0;
    }
  }

  void flush_ingress(uint64_t lid, Listener& l) {
    if (l.ingress_count == 0) return;
    ingress_batches_++;
    emit(Event{EV_RECV_BATCH, lid, l.ingress_count,
               std::move(l.ingress_buf)});
    l.ingress_buf.clear();  // moved-from: reset to a known state
    l.ingress_count = 0;
  }

  // The general-ingress mirror of flush_vote_batches: every frame parsed
  // this cycle reaches Python as one aggregated event per listener.
  void flush_ingress_batches() {
    for (auto& [lid, l] : listeners_) flush_ingress(lid, l);
  }

  void flush_inbound(InConn& c) {
    if (c.outbuf.size() > IN_OUTBUF_CAP) {
      drop_inbound(c.id);  // peer reads nothing: hostile or dead
      return;
    }
    while (!c.outbuf.empty()) {
      ssize_t w = write(c.fd, c.outbuf.data(), c.outbuf.size());
      if (w > 0) {
        c.outbuf.erase(0, size_t(w));
      } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        break;
      } else {
        drop_inbound(c.id);
        return;
      }
    }
    epoll_event ev{};
    ev.events = (c.paused ? 0u : uint32_t(EPOLLIN)) |
                (c.outbuf.empty() ? 0u : uint32_t(EPOLLOUT));
    ev.data.u64 = TAG_IN | c.id;
    epoll_ctl(epfd_, EPOLL_CTL_MOD, c.fd, &ev);
  }

  // ---- fault injection (hs_net_faults) ----

  static uint64_t xorshift64(uint64_t& s) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }

  // Parse the fault spec (loop thread): whitespace-separated tokens,
  // "seed:<u64>" or "<ip>:<port>:<drop_ppm>:<delay_ms>". An empty spec
  // clears the table. Per-peer RNG streams derive from the seed and the
  // peer key, so the same seed + same frame sequence replays the same
  // drop pattern.
  void set_faults(const std::string& spec) {
    fault_peers_.clear();
    uint64_t seed = 0x9e3779b97f4a7c15ull;
    size_t pos = 0;
    while (pos < spec.size()) {
      size_t end = spec.find(' ', pos);
      if (end == std::string::npos) end = spec.size();
      std::string tok = spec.substr(pos, end - pos);
      pos = end + 1;
      if (tok.empty()) continue;
      if (tok.rfind("seed:", 0) == 0) {
        seed = strtoull(tok.c_str() + 5, nullptr, 10);
        continue;
      }
      // ip:port:drop_ppm:delay_ms (rightmost-first split keeps IPv4 ':'
      // out of the picture — hosts here are dotted quads).
      size_t p3 = tok.rfind(':');
      size_t p2 = p3 == std::string::npos ? p3 : tok.rfind(':', p3 - 1);
      size_t p1 = p2 == std::string::npos ? p2 : tok.rfind(':', p2 - 1);
      if (p1 == std::string::npos || p1 == 0) continue;
      std::string peer = tok.substr(0, p2);  // "ip:port"
      PeerFault f;
      f.drop_ppm = uint32_t(strtoul(tok.c_str() + p2 + 1, nullptr, 10));
      f.delay_ms = uint32_t(strtoul(tok.c_str() + p3 + 1, nullptr, 10));
      f.rng = (seed ^ std::hash<std::string>()(peer)) | 1;  // nonzero
      fault_peers_[peer] = f;
    }
  }

  // True when the fault table consumed the frame (dropped, or parked for
  // delayed delivery). Best-effort frames only — callers on the reliable
  // path never consult this (replay semantics would turn injected loss
  // into duplicate delivery, which the Python fault plane models
  // explicitly instead).
  bool fault_intercept(const std::string& host, uint16_t port,
                       const std::string& frame) {
    if (fault_peers_.empty()) return false;
    std::string peer = host + ":" + std::to_string(port);
    auto it = fault_peers_.find(peer);
    if (it == fault_peers_.end()) return false;
    PeerFault& f = it->second;
    if (f.drop_ppm != 0 && xorshift64(f.rng) % 1000000u < f.drop_ppm) {
      faults_dropped_++;
      return true;
    }
    if (f.delay_ms != 0) {
      delayed_frames_.emplace(now_ms() + f.delay_ms,
                              DelayedFrame{host, port, frame});
      faults_delayed_++;
      return true;
    }
    return false;
  }

  void flush_delayed_frames(uint64_t now) {
    while (!delayed_frames_.empty() &&
           delayed_frames_.begin()->first <= now) {
      DelayedFrame df = std::move(delayed_frames_.begin()->second);
      delayed_frames_.erase(delayed_frames_.begin());
      OutConn& c = out_conn(df.host, df.port, false);
      if (c.pending.size() >= SIMPLE_QUEUE_CAP) {
        send_drops_++;
        continue;
      }
      PendingMsg m;
      m.msg_id = 0;
      m.frame = std::move(df.frame);
      c.pending.push_back(std::move(m));
      if (c.fd < 0 && !c.connecting) start_connect(c);
      if (c.fd >= 0 && !c.connecting) pump_out(c);
    }
  }

  // ---- outbound ----

  OutConn& out_conn(const std::string& host, uint16_t port, bool reliable) {
    AddrKey key{host, port, reliable};
    auto it = out_conns_.find(key);
    if (it == out_conns_.end()) {
      uint64_t slot = next_out_slot_++;
      OutConn& c = out_conns_[key];
      c.key_hash = slot;
      c.host = host;
      c.port = port;
      c.reliable = reliable;
      out_by_slot_[slot] = key;
      return c;
    }
    return it->second;
  }

  void send_simple(const std::string& host, uint16_t port,
                   const std::string& payload) {
    PendingMsg m;
    m.msg_id = 0;
    frame_append(m.frame, reinterpret_cast<const uint8_t*>(payload.data()),
                 uint32_t(payload.size()));
    if (fault_intercept(host, port, m.frame)) return;
    OutConn& c = out_conn(host, port, false);
    if (c.pending.size() >= SIMPLE_QUEUE_CAP) {  // best-effort drop
      send_drops_++;
      return;
    }
    c.pending.push_back(std::move(m));
    if (c.fd < 0 && !c.connecting) start_connect(c);
    if (c.fd >= 0 && !c.connecting) pump_out(c);
  }

  // One command for a whole best-effort broadcast: the frame is built
  // ONCE (length prefix + payload) and queued per peer, instead of one
  // Python->C crossing and one frame_append per peer. ``addrs`` is
  // space-separated "ip:port" tokens (resolved by the Python side).
  void broadcast_simple(const std::string& addrs, const std::string& payload) {
    std::string frame;
    frame_append(frame, reinterpret_cast<const uint8_t*>(payload.data()),
                 uint32_t(payload.size()));
    size_t pos = 0;
    while (pos < addrs.size()) {
      size_t sp = addrs.find(' ', pos);
      if (sp == std::string::npos) sp = addrs.size();
      size_t colon = addrs.rfind(':', sp);
      if (colon != std::string::npos && colon > pos) {
        std::string host = addrs.substr(pos, colon - pos);
        uint16_t port =
            uint16_t(strtoul(addrs.c_str() + colon + 1, nullptr, 10));
        if (fault_intercept(host, port, frame)) {
          pos = sp + 1;
          continue;
        }
        OutConn& c = out_conn(host, port, false);
        if (c.pending.size() < SIMPLE_QUEUE_CAP) {
          PendingMsg m;
          m.msg_id = 0;
          m.frame = frame;  // shared encode: one build, N queued copies
          c.pending.push_back(std::move(m));
          if (c.fd < 0 && !c.connecting) start_connect(c);
          if (c.fd >= 0 && !c.connecting) pump_out(c);
        } else {
          send_drops_++;
        }
      }
      pos = sp + 1;
    }
  }

  void send_reliable(const std::string& host, uint16_t port, uint64_t msg_id,
                     const std::string& payload) {
    OutConn& c = out_conn(host, port, true);
    PendingMsg m;
    m.msg_id = msg_id;
    frame_append(m.frame, reinterpret_cast<const uint8_t*>(payload.data()),
                 uint32_t(payload.size()));
    c.pending.push_back(std::move(m));
    if (c.fd < 0 && !c.connecting && c.next_retry_ms <= now_ms()) {
      start_connect(c);
    }
    if (c.fd >= 0 && !c.connecting) pump_out(c);
  }

  void start_connect(OutConn& c) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
    if (fd < 0) {
      conn_failed(c);
      return;
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(c.port);
    if (inet_pton(AF_INET, c.host.c_str(), &addr.sin_addr) != 1) {
      close(fd);
      conn_failed(c);
      return;
    }
    int r = connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr);
    if (r < 0 && errno != EINPROGRESS) {
      close(fd);
      conn_failed(c);
      return;
    }
    c.fd = fd;
    c.connecting = (r < 0);
    epoll_event ev{};
    ev.events = EPOLLIN | EPOLLOUT;
    ev.data.u64 = TAG_OUT | c.key_hash;
    epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev);
    if (!c.connecting) on_connected(c);
  }

  void on_connected(OutConn& c) {
    c.connecting = false;
    c.backoff_ms = RETRY_DELAY_MS;
    if (c.reliable && !c.inflight.empty()) {
      // Replay un-ACKed frames ahead of queued ones.
      for (auto it = c.inflight.rbegin(); it != c.inflight.rend(); ++it) {
        c.pending.push_front(std::move(*it));
      }
      c.inflight.clear();
    }
    c.outbuf.clear();
    pump_out(c);
  }

  void conn_failed(OutConn& c) {
    if (c.fd >= 0) {
      epoll_ctl(epfd_, EPOLL_CTL_DEL, c.fd, nullptr);
      close(c.fd);
      c.fd = -1;
    }
    c.connecting = false;
    c.outbuf.clear();
    c.inbuf.clear();
    if (c.reliable) {
      // FIFO pairing on this socket is over: cancelled inflight messages
      // need neither replay nor their cancelled_ marker.
      for (auto it = c.inflight.begin(); it != c.inflight.end();) {
        if (it->msg_id != 0 && cancelled_.erase(it->msg_id)) {
          it = c.inflight.erase(it);
        } else {
          ++it;
        }
      }
      c.next_retry_ms = now_ms() + uint64_t(c.backoff_ms);
      c.backoff_ms = std::min(c.backoff_ms * 2, RETRY_CAP_MS);
    } else {
      // Best-effort: queued frames die with the connection. The entry
      // stays in the map (bounded by distinct peer addresses) so callers
      // holding a reference across this call never dangle; the next send
      // reconnects through it.
      c.pending.clear();
    }
  }

  // Gathered write: the leftover staging buffer plus up to IOV_FRAMES
  // pending frames go out in ONE writev per round trip — pre-serialized
  // frames are never copied into a contiguous buffer on the happy path
  // (only a short write's partial frame leaves a remainder in outbuf).
  // Reliable frames enter ``inflight`` exactly when their bytes reach the
  // socket, preserving FIFO ACK pairing across partial writes.
  static constexpr int IOV_FRAMES = 63;

  void pump_out(OutConn& c) {
    while (true) {
      iovec iov[IOV_FRAMES + 1];
      int iovcnt = 0;
      size_t planned = 0;
      if (!c.outbuf.empty()) {
        iov[iovcnt++] = {c.outbuf.data(), c.outbuf.size()};
        planned += c.outbuf.size();
      }
      std::vector<PendingMsg> staged;
      while (!c.pending.empty() && iovcnt + int(staged.size()) <= IOV_FRAMES &&
             planned < (1u << 20)) {
        PendingMsg m = std::move(c.pending.front());
        c.pending.pop_front();
        if (m.msg_id && cancelled_.count(m.msg_id)) {
          cancelled_.erase(m.msg_id);
          continue;
        }
        planned += m.frame.size();
        staged.push_back(std::move(m));
      }
      for (size_t i = 0; i < staged.size(); i++) {
        iov[iovcnt++] = {staged[i].frame.data(), staged[i].frame.size()};
      }
      if (planned == 0) break;
      ssize_t w = writev(c.fd, iov, iovcnt);
      if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        w = 0;
      } else if (w < 0) {
        // Put the staged frames back for conn_failed's replay accounting
        // (reliable) / drop (simple) — none of their bytes were written.
        for (auto it = staged.rbegin(); it != staged.rend(); ++it) {
          c.pending.push_front(std::move(*it));
        }
        conn_failed(c);
        return;
      }
      if (w > 0) {
        writev_calls_++;
        bytes_tx_ += uint64_t(w);
      }
      size_t remaining = size_t(w);
      if (!c.outbuf.empty()) {
        size_t take = std::min(remaining, c.outbuf.size());
        c.outbuf.erase(0, take);
        remaining -= take;
      }
      size_t i = 0;
      for (; i < staged.size(); i++) {
        if (c.outbuf.empty() && remaining >= staged[i].frame.size()) {
          remaining -= staged[i].frame.size();
          frames_tx_++;
          if (c.reliable) c.inflight.push_back(std::move(staged[i]));
          continue;
        }
        break;
      }
      if (i < staged.size()) {
        if (c.outbuf.empty() && remaining > 0) {
          // Partially written frame: its unwritten tail becomes the new
          // staging buffer; the frame itself is on the wire (inflight).
          c.outbuf.assign(staged[i].frame, remaining,
                          staged[i].frame.size() - remaining);
          frames_tx_++;  // dispatched: its tail drains via outbuf
          if (c.reliable) c.inflight.push_back(std::move(staged[i]));
          i++;
        }
        // Untouched frames return to the queue front, order preserved.
        for (size_t j = staged.size(); j > i; j--) {
          c.pending.push_front(std::move(staged[j - 1]));
        }
      }
      if (size_t(w) < planned) break;  // kernel buffer full: wait for EPOLLOUT
      if (c.pending.empty()) break;
    }
    epoll_event ev{};
    ev.events = EPOLLIN |
                ((c.outbuf.empty() && c.pending.empty()) ? 0u : uint32_t(EPOLLOUT));
    ev.data.u64 = TAG_OUT | c.key_hash;
    epoll_ctl(epfd_, EPOLL_CTL_MOD, c.fd, &ev);
  }

  void handle_outbound(uint64_t slot, uint32_t flags) {
    auto kit = out_by_slot_.find(slot);
    if (kit == out_by_slot_.end()) return;
    auto cit = out_conns_.find(kit->second);
    if (cit == out_conns_.end()) return;
    OutConn& c = cit->second;
    if (c.connecting) {
      int err = 0;
      socklen_t len = sizeof err;
      getsockopt(c.fd, SOL_SOCKET, SO_ERROR, &err, &len);
      if (err != 0 || (flags & (EPOLLERR | EPOLLHUP))) {
        conn_failed(c);
        return;
      }
      on_connected(c);
      return;
    }
    if (flags & (EPOLLERR | EPOLLHUP)) {
      conn_failed(c);
      return;
    }
    if (flags & EPOLLIN) {
      // As in handle_inbound: parse BEFORE acting on eof/error. A peer
      // that writes its ACK and closes (one-shot servers; restarting
      // nodes) routinely delivers data+FIN in one epoll wake on
      // loopback — failing the connection first would discard the ACK,
      // leave the message "un-ACKed", and replay it forever against a
      // listener that no longer exists.
      bool conn_gone = false;
      char buf[16 * 1024];
      while (true) {
        ssize_t r = read(c.fd, buf, sizeof buf);
        if (r > 0) {
          if (c.reliable) {
            c.inbuf.append(buf, size_t(r));
          }  // simple: replies discarded
        } else if (r == 0 ||
                   (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
          conn_gone = true;
          break;
        } else {
          break;
        }
      }
      if (c.reliable) {
        size_t off = 0;
        while (c.inbuf.size() - off >= 4) {
          const uint8_t* p =
              reinterpret_cast<const uint8_t*>(c.inbuf.data()) + off;
          uint32_t len = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
          if (len > MAX_FRAME) {
            conn_failed(c);
            return;
          }
          if (c.inbuf.size() - off - 4 < len) break;
          std::string ack = c.inbuf.substr(off + 4, len);
          off += 4 + len;
          // FIFO-pair with the oldest non-cancelled in-flight message
          // (reference reliable_sender.rs ack_loop semantics).
          while (!c.inflight.empty()) {
            PendingMsg m = std::move(c.inflight.front());
            c.inflight.pop_front();
            if (cancelled_.count(m.msg_id)) {
              cancelled_.erase(m.msg_id);
              continue;
            }
            emit(Event{EV_ACKED, m.msg_id, 0, std::move(ack)});
            break;
          }
        }
        if (off) c.inbuf.erase(0, off);
      }
      if (conn_gone) {
        conn_failed(c);  // ACKs above were paired first
        return;
      }
    }
    if (flags & EPOLLOUT) pump_out(c);
  }

  int epfd_;
  int cmd_efd_;
  int out_efd_;
  std::thread thread_;
  bool stop_ = false;
  std::atomic<bool> cmd_signaled_{false};
  std::atomic<bool> out_signaled_{false};

  std::mutex cmd_mu_;
  std::deque<Command> commands_;
  bool accepting_ = true;  // guarded by cmd_mu_; false once loop() exits

  std::mutex ev_mu_;
  std::deque<Event> events_;

  uint64_t next_listener_id_ = 1;
  uint64_t next_conn_id_ = 1;
  uint64_t next_out_slot_ = 1;
  uint64_t votes_batched_ = 0;  // loop thread only
  uint64_t votes_dropped_ = 0;
  uint64_t votes_dropped_dup_ = 0;
  uint64_t frames_rx_ = 0;
  uint64_t bytes_rx_ = 0;
  uint64_t frames_tx_ = 0;
  uint64_t bytes_tx_ = 0;
  uint64_t writev_calls_ = 0;
  uint64_t send_drops_ = 0;
  uint64_t faults_dropped_ = 0;
  uint64_t faults_delayed_ = 0;
  uint64_t loop_polls_ = 0;  // poll-loop timing (all loop thread only)
  uint64_t poll_ns_ = 0;
  uint64_t dispatch_ns_ = 0;
  uint64_t cmds_serviced_ = 0;
  uint64_t cmd_service_ns_ = 0;
  uint64_t cmd_service_max_ns_ = 0;
  uint64_t ingress_reads_ = 0;  // batched-ingress account (loop thread)
  uint64_t ingress_frames_ = 0;
  uint64_t ingress_batches_ = 0;

  std::unordered_map<uint64_t, Listener> listeners_;  // loop thread only
  std::unordered_map<uint64_t, InConn> in_conns_;
  std::unordered_map<AddrKey, OutConn, AddrKeyHash> out_conns_;
  std::unordered_map<uint64_t, AddrKey> out_by_slot_;
  std::unordered_set<uint64_t> cancelled_;
  // hs_net_faults state (loop thread only).
  std::unordered_map<std::string, PeerFault> fault_peers_;
  std::multimap<uint64_t, DelayedFrame> delayed_frames_;  // release_ms
};

}  // namespace

extern "C" {

void* hs_net_create() { return new NetCore(); }

void hs_net_destroy(void* ctx) { delete static_cast<NetCore*>(ctx); }

int hs_net_event_fd(void* ctx) {
  return static_cast<NetCore*>(ctx)->out_event_fd();
}

// high_water/low_water bound the listener's emitted-but-undispatched
// event count (0 = unbounded): past high the loop stops reading the
// listener's sockets until hs_net_consumed reports progress below low.
int64_t hs_net_listen(void* ctx, const char* host, uint16_t port,
                      int auto_ack, uint32_t high_water,
                      uint32_t low_water) {
  return static_cast<NetCore*>(ctx)->listen_on(host, port, auto_ack != 0,
                                               high_water, low_water);
}

void hs_net_consumed(void* ctx, uint64_t listener_id, uint64_t n) {
  Command c;
  c.type = CMD_CONSUMED;
  c.id = listener_id;
  c.count = n;
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

void hs_net_send(void* ctx, const char* host, uint16_t port,
                 const uint8_t* data, uint32_t len, int reliable,
                 uint64_t msg_id) {
  Command c;
  c.type = reliable ? CMD_SEND_RELIABLE : CMD_SEND_SIMPLE;
  c.host = host;
  c.port = port;
  c.id = msg_id;
  c.payload.assign(reinterpret_cast<const char*>(data), len);
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

// Install (or clear, with n_authors=0) the vote pre-stage on a listener:
// ``authors`` is n_authors*32 bytes of committee public keys. Frames that
// match the fixed Vote wire layout are then length-validated, decoded,
// seat-checked, round-gated and deduped on the loop thread, and admitted
// votes reach Python as ONE EV_VOTE_BATCH per poll cycle.
void hs_net_set_vote_filter(void* ctx, uint64_t listener_id,
                            const uint8_t* authors, uint32_t n_authors) {
  Command c;
  c.type = CMD_SET_VOTE_FILTER;
  c.id = listener_id;
  if (authors != nullptr && n_authors > 0) {
    c.payload.assign(reinterpret_cast<const char*>(authors),
                     size_t(n_authors) * 32);
  }
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

// Advance the pre-stage's stale-round cutoff (monotonic; lower values
// are ignored). Also GCs dedupe state for rounds below the cutoff.
void hs_net_set_round(void* ctx, uint64_t listener_id, uint64_t round) {
  Command c;
  c.type = CMD_SET_ROUND;
  c.id = listener_id;
  c.count = round;
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

// Best-effort broadcast: one command, one frame build, N peer queues.
// ``addrs``/``addrs_len``: space-separated "ip:port" tokens.
void hs_net_broadcast(void* ctx, const char* addrs, uint32_t addrs_len,
                      const uint8_t* data, uint32_t len) {
  Command c;
  c.type = CMD_BROADCAST;
  c.host.assign(addrs, addrs_len);
  c.payload.assign(reinterpret_cast<const char*>(data), len);
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

// Test-only per-peer fault-injection table (the chaos plane's native
// hook): ``spec`` is whitespace-separated tokens — "seed:<u64>" and
// "<ip>:<port>:<drop_ppm>:<delay_ms>" — replacing the whole table; an
// empty spec clears it. Rules affect best-effort frames only (simple
// sends + broadcasts). Never enable in production deployments.
void hs_net_faults(void* ctx, const char* spec, uint32_t spec_len) {
  Command c;
  c.type = CMD_SET_FAULTS;
  c.payload.assign(spec, spec_len);
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

// Command ring flush: ``buf`` holds ``len`` bytes of fixed-layout
// little-endian records appended by the Python side over one event-loop
// iteration, decoded here into ordinary commands and enqueued under ONE
// cmd_mu_ acquisition + ONE eventfd wake. This is the batched form of
// the per-call entry points above — at committee scale the Python loop
// was paying ~N GIL re-acquisitions per round for hs_net_set_round /
// hs_net_send / hs_net_consumed crossings alone (85% of the N=200 vote
// edge, per the committed profile); the ring collapses them into one
// crossing per loop iteration. Record layouts (all integers LE):
//   op=1 SET_ROUND:       u8 op | u64 listener_id | u64 round
//   op=2 CONSUMED:        u8 op | u64 listener_id | u64 n
//   op=3 SEND_SIMPLE:     u8 op | u16 port | u8 host_len | u32 payload_len
//                         | host | payload
//   op=4 BROADCAST:       u8 op | u16 addrs_len | u32 payload_len
//                         | addrs ("ip:port ip:port ...") | payload
//   op=5 SET_VOTE_FILTER: u8 op | u64 listener_id | u32 payload_len
//                         | n*32B author keys
//   op=6 REPLY:           u8 op | u64 conn_id | u32 payload_len | payload
//   op=7 SEND_RELIABLE:   u8 op | u16 port | u8 host_len | u64 msg_id
//                         | u32 payload_len | host | payload
// A malformed record ends the parse (the Python side is the only
// producer; truncation can only mean a caller bug, and enqueueing a
// half-parsed tail would be worse than dropping it). Returns the number
// of records enqueued, or -1 when the loop has shut down.
int64_t hs_net_cmds_flush(void* ctx, const uint8_t* buf, uint32_t len) {
  std::deque<Command> cmds;
  uint32_t off = 0;
  auto rd_u16 = [&](uint32_t at) {
    uint16_t v;
    memcpy(&v, buf + at, 2);
    return v;
  };
  auto rd_u32 = [&](uint32_t at) {
    uint32_t v;
    memcpy(&v, buf + at, 4);
    return v;
  };
  auto rd_u64 = [&](uint32_t at) {
    uint64_t v;
    memcpy(&v, buf + at, 8);
    return v;
  };
  while (off < len) {
    uint8_t op = buf[off];
    Command c;
    if ((op == 1 || op == 2) && off + 17 <= len) {
      c.type = (op == 1) ? CMD_SET_ROUND : CMD_CONSUMED;
      c.id = rd_u64(off + 1);
      c.count = rd_u64(off + 9);
      off += 17;
    } else if (op == 3 && off + 8 <= len) {
      uint16_t port = rd_u16(off + 1);
      uint8_t hlen = buf[off + 3];
      uint32_t plen = rd_u32(off + 4);
      if (off + 8 + hlen + uint64_t(plen) > len) break;
      c.type = CMD_SEND_SIMPLE;
      c.host.assign(reinterpret_cast<const char*>(buf + off + 8), hlen);
      c.port = port;
      c.payload.assign(
          reinterpret_cast<const char*>(buf + off + 8 + hlen), plen);
      off += 8 + hlen + plen;
    } else if (op == 4 && off + 7 <= len) {
      uint16_t alen = rd_u16(off + 1);
      uint32_t plen = rd_u32(off + 3);
      if (off + 7 + alen + uint64_t(plen) > len) break;
      c.type = CMD_BROADCAST;
      c.host.assign(reinterpret_cast<const char*>(buf + off + 7), alen);
      c.payload.assign(
          reinterpret_cast<const char*>(buf + off + 7 + alen), plen);
      off += 7 + alen + plen;
    } else if (op == 5 && off + 13 <= len) {
      uint32_t plen = rd_u32(off + 9);
      if (off + 13 + uint64_t(plen) > len) break;
      c.type = CMD_SET_VOTE_FILTER;
      c.id = rd_u64(off + 1);
      c.payload.assign(
          reinterpret_cast<const char*>(buf + off + 13), plen);
      off += 13 + plen;
    } else if (op == 6 && off + 13 <= len) {
      uint32_t plen = rd_u32(off + 9);
      if (off + 13 + uint64_t(plen) > len) break;
      c.type = CMD_REPLY;
      c.id = rd_u64(off + 1);
      c.payload.assign(
          reinterpret_cast<const char*>(buf + off + 13), plen);
      off += 13 + plen;
    } else if (op == 7 && off + 16 <= len) {
      uint16_t port = rd_u16(off + 1);
      uint8_t hlen = buf[off + 3];
      uint64_t msg_id = rd_u64(off + 4);
      uint32_t plen = rd_u32(off + 12);
      if (off + 16 + hlen + uint64_t(plen) > len) break;
      c.type = CMD_SEND_RELIABLE;
      c.host.assign(reinterpret_cast<const char*>(buf + off + 16), hlen);
      c.port = port;
      c.id = msg_id;
      c.payload.assign(
          reinterpret_cast<const char*>(buf + off + 16 + hlen), plen);
      off += 16 + hlen + plen;
    } else {
      break;  // unknown op or truncated record: stop
    }
    cmds.push_back(std::move(c));
  }
  int64_t n = int64_t(cmds.size());
  if (n == 0) return 0;
  if (!static_cast<NetCore*>(ctx)->push_cmds(std::move(cmds))) return -1;
  return n;
}

void hs_net_close_listener(void* ctx, uint64_t listener_id) {
  Command c;
  c.type = CMD_CLOSE_LISTENER;
  c.id = listener_id;
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

void hs_net_pause_listener(void* ctx, uint64_t listener_id, int paused) {
  Command c;
  c.type = paused ? CMD_PAUSE_LISTENER : CMD_RESUME_LISTENER;
  c.id = listener_id;
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

void hs_net_cancel(void* ctx, uint64_t msg_id) {
  Command c;
  c.type = CMD_CANCEL;
  c.id = msg_id;
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

void hs_net_reply(void* ctx, uint64_t conn_id, const uint8_t* data,
                  uint32_t len) {
  Command c;
  c.type = CMD_REPLY;
  c.id = conn_id;
  c.payload.assign(reinterpret_cast<const char*>(data), len);
  static_cast<NetCore*>(ctx)->push_cmd(std::move(c));
}

int64_t hs_net_drain(void* ctx, uint8_t* buf, uint32_t cap) {
  return static_cast<NetCore*>(ctx)->drain(buf, cap);
}

// out[7] = {pending, inflight, cancelled, out_conns, in_conns,
// votes_batched, votes_dropped}. Blocks until the loop thread services
// the request (microseconds when live).
//
// Destroy contract (applies to hs_net_stats_ex too): this call must not
// race hs_net_destroy — the caller blocks on loop-thread servicing, and
// a context freed mid-wait is a use-after-free no in-library ordering
// can repair. The ctypes wrapper sequences destroy after every other
// call has returned; a call that merely LOSES the race to shutdown (the
// loop already exited but the context is alive) safely returns zeros
// via the push_cmd(false) path below.
void hs_net_stats(void* ctx, uint64_t* out) {
  StatsReq req;
  Command c;
  c.type = CMD_STATS;
  c.ptr = &req;
  if (!static_cast<NetCore*>(ctx)->push_cmd(std::move(c))) {
    // Loop thread already exited: report zeros instead of blocking on a
    // request nothing will ever service.
    for (int i = 0; i < 7; i++) out[i] = 0;
    return;
  }
  std::unique_lock<std::mutex> lk(req.mu);
  req.cv.wait(lk, [&] { return req.done; });
  out[0] = req.pending;
  out[1] = req.inflight;
  out[2] = req.cancelled;
  out[3] = req.out_conns;
  out[4] = req.in_conns;
  out[5] = req.votes_batched;
  out[6] = req.votes_dropped;
}

// Extended snapshot: fills up to ``cap`` slots in the order
// {pending, inflight, cancelled, out_conns, in_conns, votes_batched,
//  votes_dropped, votes_dropped_dup, frames_rx, bytes_rx, frames_tx,
//  bytes_tx, writev_calls, send_drops, faults_dropped, faults_delayed,
//  loop_polls, poll_ns, dispatch_ns, cmds_serviced, cmd_service_ns,
//  cmd_service_max_ns, ingress_reads, ingress_frames, ingress_batches}
// and returns the number filled (new fields append, existing indices
// never move — callers probe the return value instead of pinning a
// struct version). Same loop-thread servicing — and the same
// no-race-with-destroy contract — as hs_net_stats.
int hs_net_stats_ex(void* ctx, uint64_t* out, int cap) {
  constexpr int N_FIELDS = 25;
  if (out == nullptr || cap <= 0) return 0;
  StatsReq req;
  Command c;
  c.type = CMD_STATS;
  c.ptr = &req;
  if (!static_cast<NetCore*>(ctx)->push_cmd(std::move(c))) {
    for (int i = 0; i < cap; i++) out[i] = 0;
    return cap < N_FIELDS ? cap : N_FIELDS;
  }
  std::unique_lock<std::mutex> lk(req.mu);
  req.cv.wait(lk, [&] { return req.done; });
  const uint64_t fields[N_FIELDS] = {
      req.pending,       req.inflight,     req.cancelled,
      req.out_conns,     req.in_conns,     req.votes_batched,
      req.votes_dropped, req.votes_dropped_dup, req.frames_rx,
      req.bytes_rx,      req.frames_tx,    req.bytes_tx,
      req.writev_calls,  req.send_drops,   req.faults_dropped,
      req.faults_delayed, req.loop_polls,  req.poll_ns,
      req.dispatch_ns,   req.cmds_serviced, req.cmd_service_ns,
      req.cmd_service_max_ns, req.ingress_reads, req.ingress_frames,
      req.ingress_batches,
  };
  int n = cap < N_FIELDS ? cap : N_FIELDS;
  for (int i = 0; i < n; i++) out[i] = fields[i];
  return n;
}

}  // extern "C"
